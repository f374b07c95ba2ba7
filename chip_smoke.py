#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fissure_segmentation_tpu_torch) on
one NVIDIA card. Run from the repository root:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, nothing falls back to the CPU:
  1. card and settings: CUDA present, card name and power limit, TF32 off,
     the native C++ host runtime built from native/src with g++;
  2. build every kernel from kernels/csrc with nvcc (timed);
  3. K1 (kNN) against its plain PyTorch version on the card, at the three
     shapes the serving and training paths give it, a ragged N, a lattice
     full of ties, and the selection's hard cases (every key an insert,
     only ties, the masked normals' cloud, kk at the list's row edges,
     N = kk, a cloud larger than the kernel stages whole; DSEG-AE's
     padding graph, kk = 2 on a case whose invalid points sit at 1e6, one
     class valid and 30 points valid): indices and distances must be
     equal; median times of both at the path shapes (also the PC-AE's
     (32, 1024, 3) kk = 20 and DSEG-AE's dynamic (5, 2048, 3) kk = 40);
  4. the serving slice at full size: a synthetic 256^3 CT, DGCNNSeg(k=40)
     with seeded random weights and a coordinate-keyed class bias added
     after the full forward (untrained weights put every keypoint in one
     class), segment_case with its defaults — one warm-up, then timed
     cases; checks keypoints, per-class meshes, labelmap, finiteness, and
     that every case launched K1 at least 11 times (10 ensemble groups +
     the normals) and the gather-reduce at least 20 (10 groups x the two
     fused EdgeConvs);
  5. reference check on a small input: the same slice at 128^3 on the card
     (kernels) and on the CPU (plain versions) must agree;
  6. the graph transpose and K2-K4 (the EdgeConv scatter kernels) against
     their plain versions on the card, at the train step's shapes (B=32,
     N=2048, k=40, C=64, the graph from K1) and a ragged shape with dropped
     targets, K2 with f32 and bf16 payloads: the transpose's (order, ptr)
     equal (also at its hard cases: a hub row of in-degree 1250, every
     edge into one row, empty rows, targets dropped on both sides,
     n_rows = 1, no edges, 60 000 rows), both K4 kernels (the histogram of
     idx, the in-degrees from the transpose's row offsets) equal, also at
     P1's 512 rows and at their hard cases (targets dropped on both sides,
     a hub, n_rows = 1, B = 1 and 22, E off 16-byte loads, idx off a
     16-byte boundary, 60 000 rows: the counters in device memory), K2/K3
     within twice the worst-case float32 rounding of a sequential sum (both
     sides sum the same values in different orders), two launches
     bit-equal and a shared transpose changing nothing; K3 with f32 and
     bf16 payloads and at its
     hard cases (C = 33, 36, 40, 200, 256; N where the staged slices just
     fit in shared memory and just do not, and K = 300, both the unstaged
     kernel; a hub row of in-degree 1250; kstar only at 0 and K - 1);
     K2 at the PC-AE encoder's gather backward, (32, 1024 x 20, C) f32 on
     its K1 graph for C = 64, 128, 256, within the same bound, timed with
     index_add_ beside it;
     median times of both, the transpose alone, K2 and K3 with their own
     transpose and with a shared one, and K4 by call (the histogram at
     2048 and 512 rows, the in-degrees from the step's transpose; its ms
     through the wrapper back to back like every row's, and beside it
     "device_ms", its work on the card alone from CUDA-graph replays, its
     launch being shorter than the wrapper's host time);
  7. the training slice at full width: the port's entry point
     (train_point_seg.main, synthetic data, DGCNNSeg(k=40, static), batch
     32 x 2048, f32, NNU loss + Adam) trains fold 0 for 3 epochs; checks a
     finite loss history, model.pt and moved running statistics; then 10
     timed warm steps unfused and fused (FSEG_FUSED_EDGE=0/1, the harness
     of train/profile_step.py): ms/step, clouds/s, peak device memory,
     kernel launches. K2 must launch in both routings, K3 and K4 in the
     fused one, and the graph transpose exactly once a step (shared); K4
     only from the transpose, never the histogram;
  8. train-step reference on a small input (B=2, N=256, k=8): one step on
     the card (kernels) and on the CPU (plain versions) from the same
     weights and batch, in both routings: loss within rtol 1e-5, running
     statistics within 2e-4; the forward's branches (LeakyReLU sides,
     maxima, routed slots) recorded on both sides, and on the first input
     where they all agree every gradient within 2e-4 and every updated
     parameter within 2e-4, card vs CPU where Adam's step has a sure sign
     and against the CPU's Adam on the card's gradients everywhere
     (phase_train_reference says why).

  9. K5 (farthest-point sampling) against its plain PyTorch version on the
     card at the PointTransformer path's shapes (the train step's first two
     TransitionDowns, a served ensemble group), DSEG-AE's masked shape, a
     ragged N, a lattice full of ties, C = 4, and the hard cases (only
     ties, N = 1, m above the valid count, N off every block width,
     N = 32768, C = 1 and C = 8): indices equal; median times of both,
     also at one fissure class of a synthetic case, (1, 8000, 3) m = 1024
     with 11.7 % valid;
 10. the serving slice with PointTransformerSeg at full width (seeded
     weights, the same class bias): one warm-up and 3 timed full-size
     cases with phase 4's checks; K5 must launch at least 40 times a case
     (10 ensemble groups x 4 TransitionDowns);
 11. the training slice with PointTransformerSeg at full width through the
     entry point (--model PointTransformer, 32 x 2048, 3 epochs of fold 0;
     phase 7's checks), then 10 timed warm steps (ms/step, clouds/s, peak
     memory); K5 must launch at least 4 times a step;
 12. PointTransformer train-step reference, card vs CPU, at full depth and
     width on a small batch (phase_pt_reference says which and why): every
     FPS and kNN selection recorded on both sides; FPS equal; an input
     whose kNN selections differ is set aside; on the first agreeing input
     the loss, running statistics, gradients and updated parameters are
     held as phase_pt_reference states;
 13. K6 (the 3x3x3 depthwise convolution) against its plain version on
     the card at the seven stride-1 depthwise layers of MobileNetASPP on a
     256^3 CT (six shapes), bfloat16 at the widest, and the hard cases
     (ragged shapes, H and W off the tile, C = 5, 33, 36, 96, 144, 384 and
     bfloat16 C = 12, 40, 64, 144, 192, D = 1 and 2, B = 2); K6's stride-2
     mode at block 5's serving shape (1, 128^3, 192) in f32 and bf16, the
     train step's stride-2 layers (32, 48^3, 192), (32, 48^3, 64) and
     (32, 12^3, 240), and its hard cases (odd D, H, W, D = 1 and 2, H and
     W off the tile, C = 5, 33, bf16 C = 12, 40): outputs equal; median
     times of the kernel, the plain version and cuDNN's grouped conv3d at
     the same stride (the library yardstick), with the bound;
 14. the serving slice in kp_mode="cnn" at full size: segment_case runs
     MobileNetASPP(num_classes=4) (seeded weights) on the 256^3 CT, then
     phase 4's keypoint-to-mesh path; one warm-up and 3 timed cases with
     phase 4's checks, K6 at least 7 launches a case at stride 1 and one
     at stride 2 (block 5); the CNN forward's
     time and the peak device memory; then one kp_mode="enhancement" case
     with phase 4's checks;
 15. CNN reference on a small input (40 x 48 x 56, full width): softmax
     card vs CPU within CNN_SOFT_TOL, argmax and the staged keypoints
     equal but at near-ties (phase_cnn_reference);
 16. the fused EdgeConv gather-reduce (P5's function) against its plain
     version, equal in every output, want "max", "extrema" and "all", f32
     and bf16: at the train step's shape (32, 2048, 40, 64) on K1's graph,
     the serving ensemble's (5, 2048, 40, 64; the unstaged kernel), an integer
     lattice full of k-ties, indices out of range, C = 33, 36, 40, 200,
     256, K = 70, points split among blocks, and N where the staged slice
     just fits and just does not (the unstaged kernel), each with the path it
     took; median times of the kernel, the plain version, the flat gather
     + reductions the port ran before, the library call (embedding_bag,
     "max" only) and the bound at each path call;
 17. the bf16 DGCNN training slice at full width (--amp true): 10 timed
     warm steps of DGCNNSeg(k=40, static, bf16) fused and unfused (ms/step,
     clouds/s, peak memory, launches: K2 every step in both routings, the
     gather-reduce, K3 and K4 every fused step, the transpose once a
     step, K4 only from the transpose), then the entry point with
     --amp true trains fold 0 for 3 epochs (phase 7's checks, and the model
     written as bf16);
 18. bf16 train-step reference on a small input (B=2, N=256, k=8): one
     step on the card and on the CPU from the same weights and batch, both
     routings, held within BF16_TOL (phase_bf16_reference says why); the
     same step on the card with a planted fault (a wrong neighbour in the
     backward) must miss the gradient tolerance;
 19. the probes of P1-P4 (prof/probes.py) at 3 repetitions, each variant
     checked against its plain version first (stream_sum and
     stream_sum_async within their rounding bound on the payload, equal on
     a payload of integers, where every sum is exact, and unequal there
     once a tile is zeroed; P3's totals, taken from the launch that sums
     the columns, within their own bound); the stream kernels' times
     beside their plain version, torch.sum(g), torch.sum(., 0) and the
     bound; their hard cases (probes.hard_cases: rows under the grid and
     off every tile, L = 4 ... 1024, the smallest and largest ring, calls
     back to back and on two streams at once bit-equal and equal to the
     replay of their order). P5's comparison is phase 16's. P1's
     k_onehot is the path of K4's histogram (at 512 rows);
 20. the default run of the entry point at full width (no --static, no
     --train_only: DGCNNSeg(k=40, dynamic, bf16), 32 x 2048, 3 epochs of
     fold 0, then fold 0's test), then --test_only, --speed and --copd on
     the same output: model.pt dynamic and bf16, the JAX package's CSV
     layout with finite Dice and a finite ASSD for every fissure that is
     not missing, the OBJ/NIfTI artifacts, cv_results.csv; the test half's
     inference and post-processing s/case from inference_time.csv, the
     --speed ms; then 10 timed warm dynamic bf16 steps (ms/step, clouds/s,
     peak memory, launches: three graph transposes a step, K1, K2, K3, K4,
     the gather-reduce, two fused row selections: the feature graphs) and
     the feature graph alone at (32, 2048, 64) bf16 k=40;
 21. the default run's path card against CPU on a small input
     (phase_dynamic_reference): a dynamic DGCNNSeg's f32 step (its feature
     graphs, loss, gradient, eval logits; a wrong neighbour planted in the
     feature graph must miss), its bf16 step (held against the CPU's own
     bf16 error) and test_pipeline on one case with the same injected
     draws (predictions, Dice, ASSD family; shifted surface samples must
     miss);
 22. the PC-AE entry at full width (train_pc_ae.main: k = 20, 1024
     points, latent 512, plane, batch 32, f32): --mesh trains fold 0 for 3
     epochs and tests it, the point target for 1 epoch: finite losses,
     model.pt, reconstruction_chamfer.csv; then 10 timed warm steps of the
     dynamic mesh, dynamic point and static mesh steps (ms/step, clouds/s,
     peak memory, launches: a dynamic step K1 once, the transpose and K2
     4 times each);
 23. the PC-AE step card against CPU on a small input
     (phase_pcae_reference): loss, gradient and eval vertices, a wrong
     neighbour planted in the feature graphs must miss;
 24. DSEG-AE on the card (dseg_ae_regularization.run) with a DGCNNSeg
     fold trained here (the default run's model, 40 epochs) and phase 22's
     --mesh fold: farthest sampling with padding from model.pt, the same
     from both folds re-written as model.fst by the port's writer (equal
     outputs), and accumulate; every case reconstructs a fissure, finite
     Chamfer distances, K1, K5 and the gather-reduce launched; s/case;
 25. DSEG-AE on one case card against CPU with injected draws
     (phase_dseg_reference): labels, padded points, decoded vertices and
     codes; K5's selections shifted by one point must miss;
 26. K6's backward (phase_wgrad) at strides 1 and 2: the wgrad kernel
     against the float64 plain version within gamma_depth * sum |x dy|
     (its depth from the launch plan) and equal from launch to launch,
     the dgrad (K6 with the taps flipped; at stride 2 on dy stuffed to x's
     shape) equal to its plain version, at every K6 layer of
     train_seg_cnn's step (v1: (32, 48^3, C) for C = 32, 96, 144, 192 and
     (32, 24^3, C) for C = 192, 384, block 5's stride-2 (32, 48^3, 192);
     v3's widths, its stride-2 rows (32, 48^3, 64) and (32, 12^3, 240))
     and the hard cases at both strides (C off the 32-channel groups and
     off 4, D = 1 and 2, W = 1, odd D, H, W); a dw with its centre tap
     taken one voxel off must miss the bound; median times of the wgrad
     kernel, its plain version, cuDNN's conv3d_weight at the same stride
     and the bound, of the dgrad (and at stride 2 its stuffing alone), its
     plain version and conv3d_input, summed over one v1 step;
 27. the train_seg_cnn entry at full width (phase_cnn_train: 32 patches
     of 96^3 at 1.5 mm, nnunet, f32): v1 trains fold 0 for 2 epochs and
     tests it, then --test_only; v3 trains 1 epoch and tests it (the JAX
     entry's files, finite Dice, K6's launches by role and stride and its
     wgrad's: one dgrad and one wgrad a K6 layer a step);
     10 timed warm steps of each (ms/step, patches/s, peak memory) and
     the device time of 3 by kind of kernel; one step's conv3d calls by
     groups and kernel: none grouped in v1, only the 5x5x5 ones in v3;
 28. one train step of each CNN at full width on 2 patches of 32^3, card
     against CPU with the same weights, crops, augmentation draws and
     dropout mask (phase_cnn_train_reference); the v1 step with the
     planted wgrad fault must miss the gradient tolerance;
 29. DPSR-Net at the JAX entry's full width (phase_dpsr: train_dpsr_net,
     DGCNN k = 20 dynamic f32, 32 x 1024 points, 128^3 grid, sigma 10):
     v2 trains fold 0 for 3 epochs (the Chamfer term on from epoch 1) and
     tests it, 10 timed steps with the Chamfer term on (ms/step, clouds/s,
     peak memory, launches, device ms by stage from the forward's profiler
     ranges), then v1 1 epoch and 3 timed steps (K1 also on the B x 3
     masked class clouds);
 30. DPSR-Net v2 card against CPU at 2 x 256 points, a 24^3 grid
     (phase_dpsr_reference): logits, PSR grids, samples, the gradient and
     the Chamfer term's gradient within DPSR_TOL; a splat with one corner
     dropped and a marching step without its gradient must miss them;
 31. DG-SSM at the JAX entry's full width (phase_dgssm: train_dgcnn_ssm
     with --predict_affine, k = 20 dynamic, 32 x 1024): 3 epochs of fold
     0 and test_dgssm, its s/case, then 10 timed steps;
 32. a DG-SSM step card against CPU, 4 clouds of 256 points
     (phase_dgssm_reference), within DGSSM_TOL;
 33. the dataset front end at full size (phase_preprocess): one synthetic
     256^3 case (the image x 1000, as the entry does) through
     preprocess_dataset.process_case on the card, Förstner keypoints with
     MIND-SSC features, then again in the cnn keypoint mode with a seeded
     MobileNetASPP written as .fst by the port (its softmax in bfloat16):
     the synced seconds of each stage (crop + GT, mask_lr, the Poisson fit
     per fissure label and its labelmap, masking, find_lobes' morphology,
     components and random walk, lobe meshes, the CNN, keypoints,
     features, writing), the peak memory and the launches; success, lobes
     exactly {1, 2, 3, 4}, non-empty fissure meshes, >= 2048 keypoints,
     finite (N, 12) features ((N, 5^3 x 4) in the cnn run), K1 once a
     fissure label at least, K6 at both strides in the cnn run, the files
     read back; then the random walk alone at that size (ms an iteration,
     peak memory, busy share from the profiler) and one lobe mesh's
     marching (time, peak memory);
 34. K1 at phase 33's fissure clouds, (1, N, 3) kk = 30 with N the
     label's voxel count (K1's tiled branch above 16 384 points): indices
     and distances equal to knn_plain's on every query row, compared in
     row blocks (knn_plain would hold N^2 distances), median times of both
     and the bound; K6 at every (shape, dtype, stride) the cnn run gave it
     (bfloat16), equal to its plain version, with cuDNN's grouped conv3d
     and the bound;
 35. the chain (phase_chain): preprocess_dataset.main --synthetic 5 (the
     entry's 64^3, noisy keypoints, about 17 500 a case), train_point_seg
     --data lobes fold 0 for 3 epochs at the default run's widths, then
     fold 0's test through the lobes label space (the random-walk fill on
     the card): finite losses and Dice;
 36. one 96^3 case card against CPU with the same injected draws
     (phase_preprocess_reference), within PRE_REF_TOL;
 37. PointNet at full width (phase_pointnet): train_point_seg --model
     PointNet (bf16 shared MLPs, --amp true) trains fold 0 for 3 epochs at
     32 x 2048 on the synthetic cases and tests it, then --test_only,
     --speed, the fold re-written as model.fst alone and tested (F15's
     path), one warm-up and 3 timed segment_case cases on the 256^3 CT
     with its model; again with --transformer (trained, tested, --speed);
     10 timed warm steps bf16, f32 and bf16 with the input T-Net (ms/step,
     clouds/s, peak memory, busy share); and (phase_pointnet_features,
     run before phase 35's directory goes) one fold on phase 35's point
     files, which carry MIND-SSC features (BASELINE's "w/ image
     features");
 38. PointNetSeg with both T-Nets, one train step and one eval forward
     card against CPU on 4 x 256 points, f32 and bf16
     (phase_pointnet_reference), within POINTNET_TOL;
 39. DGCNN with --transformer --img_feat_extractor (bf16, 32 x 2048, 3
     epochs of fold 0), static and dynamic, then 10 timed warm steps of
     each with their launches a step (phase_stems); one bf16 step card
     against CPU within BF16_TOL (phase_stems_reference);
 40. affine_experiments.run_example for DGCNN, OpenDGCNN and PointNet (k =
     40, 8 x 1024 a step, AFFINE_EPOCHS x AFFINE_STEPS), 10 timed warm
     steps of each with their launches (phase_affine); one step of each
     card against CPU within AFFINE_TOL (phase_affine_reference); K3 and K4
     timed at the affine DGCNN's step shapes (8, 1024, 40, C), C = 64,
     128, 256;
 41. the approximate top-k's kernels (phase_approx_topk) against their
     plain versions, bit for bit. The bin pass (k > 128) and the whole
     selection against approx_top_k_plain at (1, 256^3) -> 20 000 at
     recall 0.95 (uniform scores in f32 and bf16, the Förstner detector's
     masked score volume): the kernel's time cold and warm, its plain
     version's, the aggregation's, the selection's and torch.topk's exact
     top-k (the library column), the bound, the share of the exact top-k
     found. The fused row selection (k <= 128) against its plain version
     and the path it replaced (the bin pass and two sorts; for the exact
     feature graph the stable sort): the kNN rows (32 * 2048, 2048) -> 40
     at 0.9 (coordinate distances f32, bf16 feature distances), the
     fast-serving static graph's (10 240, 2048) rows f32 and bf16, the
     exact feature graph (32 * 2048, 2048) bf16 at kk = 40 and 41, and
     rows full of ties with signed zeros and masked +-inf (both dtypes and
     directions, k = 1, 40, 41, 128 and the exact top-41); times of the
     kernel, its plain version, the replaced path and torch.topk, the
     bound, its share, and the share of the exact top-k found;
 42. segment_cases against a serial loop of segment_case on 8 copies of
     the shared 256^3 case (phase_pipeline): the host synchronisations of
     one case's device half (torch.cuda.set_sync_debug_mode), then serial,
     pipelined, pipelined, serial, every run bit-equal to the first
     (keypoints, labels, every triangle, the labelmap); s/case, cases/s,
     the stage medians and the busy share of each mode; the splat's
     scatter at its serving shape, sorted index_put_ against index_add_;
 43. the fast variant (phase_fast_serving: DGCNNSeg bf16 with knn_recall
     0.9, the approximate Förstner selection) served as phase 42 serves,
     the bin pass at least one launch a case (the detector) and the fused
     row selection at least ten (the ensemble's static graphs); the detector's and the
     graphs' shares of the exact selection; the bf16 CNN in kp_mode="cnn"
     (f32 and bf16 timed, one case with approx_top_k), the whole volume
     and the sliding window at 256^3 in both dtypes (K6 at both strides
     in every case), and both protocols in bf16 card against CPU within
     BF16_CNN_FACTOR x the CPU's own bf16 error and at least
     BF16_CNN_MIN_SHARE x it from the card's own f32 softmax;
 44. train_point_seg --knn_recall 0.9 (phase_knn_recall_train: the
     default run's widths, 3 epochs, --train_only; model.pt keeps the
     recall), 10 timed bf16 steps dynamic and static with and without
     knn_recall, and time_keypoint_extraction on 2 copies of the 256^3
     case (its six CSV files);
 45. corresponding points (phase_correspondences): 8 synthetic 256^3
     cases, 3 fissure objects of 4096 voxels each (every case but the first
     moved by a seeded similarity), generate_corresponding_points at its
     defaults in "simple" mode (3 K5 launches) and "kmeans" (3 cases); ms
     an iteration of the rigid (12 288^2) and deformable (4096^2) CPD loops
     and their host syncs; the fixed transform the identity, cases closer
     after registration; card against CPU on a cut;
 46. register_images through its entry at 256^3 (phase_register): the
     case in HU against itself warped by a sinusoid, 50 Adam steps, the
     warped image, the fields and TRE at 200 lung landmarks; the loss falls
     and TRE improves; stage seconds and peak memory; the JAX test's
     recovery bounds at 24^3; card against CPU at 64^3;
 47. evaluate_baselines through its entry (phase_baselines), "voxels" and
     "subsample" on 2 synthetic 256^3 cases whose predictions are the
     ground truth shifted by a voxel: the JAX entry's CSV layout, finite
     values, K1 on its tiled branch held against its plain version; s/case
     by stage; card against CPU at 64^3;
 48. the shape probes (phase_shape_probes): the three of
     shape_sanity_checks at the entry's defaults within
     tests/test_shape_sanity.py's bounds (the DG-SSM toy launching K1, the
     transpose and K2), and fit_plane_to_fissure on each fissure of the
     256^3 case;
 49-52. the parallel layer (phases_parallel), in two ranks spawned on the
     one card: a two-rank gloo group (both ranks compute on cuda:0; the
     collectives go through host memory, send and receive through pinned
     host copies, which the phase prints) and, in rank 0, a one-rank NCCL
     subgroup.
 49. data-parallel training at the default run's width (DGCNNSeg k = 40,
     dynamic, bf16, 32 x 2048 a step, 16 a rank on two ranks): ten steps
     on each group against the single-device trainer at the same seed
     (the trajectory within rtol = atol = 3e-2, JAX's own bound); one
     static f32 step on an injected batch: the loss within 1e-5 relative,
     each gradient within 4x the single device's own reduction-order
     spread (the same step with the batch's halves swapped) or 1e-2 of
     its leaf's largest magnitude, the whole gradient within 4x that
     spread in relative L2; the one-rank NCCL step within 1e-6 of the
     no-group one (its operations are the single path's); ms/step, peak
     memory and busy share of each layout; then train_point_seg --dp for
     one epoch of fold 0 (one card: the single-rank path);
 50. the sharded subset ensemble in serving (the 256^3 case's 20 000
     Förstner keypoints, DGCNNSeg k = 40 static f32, 50 x 2048 subsets in
     groups of 5) against ensemble_predict on the same subsets:
     probabilities within 1e-5, the argmax equal wherever the top two are
     more than 1e-4 apart, the PSR/marching meshes equal for every class
     whose keypoints agree;
 51. the z-slab sliding window of MobileNetASPP (K6 in every block) on
     the 256^3 CT, patch 128^3, overlap 0.5, two ranks, f32, against
     predict_all_patches within atol 2e-5;
 52. the ring kNN of the case's keypoints (k = 40, no self loop) against
     K1's dense graph: sorted distances within 1e-4 relative plus 8 eps32
     of the largest |x|^2 (the ring's tile is the JAX formula, K1 sums
     exact squares), indices equal but at near-ties (counted), every merge
     selection equal to
     select_rows_plain bit for bit, the merge's calls timed; then
     parallel/dryrun.py:dryrun_multichip over two gloo ranks on the card
     (its defaults). Every call the parallel paths make of K1, K2, the
     transpose, K3 (at its own payload type) and K4 at a shape the earlier
     phases do not check is held against its plain version at that shape
     and timed (par_kernel_checks).
 53. the fused EdgeConv tail and the last of the JAX package: the tail's
     CUDA default (CUDA_TAIL_DEFAULT, FSEG_FUSED_EDGE_TAIL unset: a
     default step goes through FusedEdgeTail where it is on) and its A/B
     (phase_tail_ab: prof/tail_ab.py's static f32 and bf16, dynamic bf16
     and stems steps at 32 x 2048 and the serving ensemble on the 256^3
     case's keypoints, tail on against off, medians of TAIL_AB_RUNS runs of
     TAIL_AB_STEPS, the default no slower than TAIL_AB_NOISE; the
     host-bound serving ensemble held by its device time); a train
     step with the tail on both sides, card against CPU, f32 and bf16
     (phase_tail_reference); knn(query_chunk=) equal to the unchunked call
     at (3, 8192, 3) kk = 30 (K1) and (2, 2048, 64) bf16 kk = 40 (the
     feature route; phase_knn_chunk); PointTransformerSeg(dtype=bf16) at
     full width, card against CPU (phase_pt_bf16_reference); the fetch
     stage of segment_cases and the float path's device -> host copies of
     a case against its s/case (phase_fetch), which decide the packed
     encodings.

The CUDA default of the fused tail is on, and the CPU's off: every
card-vs-CPU phase runs with FSEG_FUSED_EDGE_TAIL set to the CUDA default,
so both sides take one route.

Kernel launch counts are set to 0 before each main path (phases 4, 10 and
14 serving, phases 7, 11 and 17 training, phase 19 the probes, phase 20
the default entry run, phase 22 the PC-AE, phase 24 DSEG-AE after its seg
fold is trained, phase 27 each train_seg_cnn run, phases 29 DPSR-Net and
31 DG-SSM, phase 33 each process_case run, phase 35 the chain, phases 37
PointNet, 39 DGCNN with both stems, 40 the affine experiments, 42 and 43
a segment_cases batch, 44 the --knn_recall entry run, 45 the "simple"
correspondences, 47 the two evaluate_baselines runs, 48 the DG-SSM toy, in each rank of phases 49-52 each path: the ten
training steps, the ensemble, the window, the ring; phase 49's --dp entry
run) and read after it;
the comparison launches of phases 3, 5, 6, 8, 9, 12, 13, 15, 16, 18, 21,
23, 25, 26, 28, 30, 32, 34, 36, 38, 39's and 40's references, 41, 42's
and 43's A/B runs and checks, 53's A/B and checks (its A/B's launches
are printed), 45's K5 check and reference, 47's K1 check
and reference, of K3 and K4 timed at DPSR-Net's and the affine step's
shapes, and of the probes' own checks are not counted. Phases 45, 47 and
48 go into the "slice" rows as paths of their own ("correspondences": K5;
"baselines": K1; "shape_probes": K1, the transpose, K2). Phases 49-52
add their launches to every row they launch and give them in a
"parallel" entry by path and layout (K6's in "by_path" as
"parallel_window"; the fused row selection's in "by_path" as "parallel",
its ring-merge calls in "by_call" with their times); K3's by_call adds
the parallel calls, priced at their shape with a float32 payload, K4's
the parallel path's calls.
Phase 44's launches count with the train paths; phases 42 and 43 add K1's
and the gather-reduce's launches of their batch.
The bin pass's row gives its launches by path (fast serving, the
--knn_recall run) and by call, with phase 41's times at each call; the
fused row selection's row its launches by path (every exact feature graph
on the card and every approximate graph) and by call where the path
records its calls (the default run, fast serving, the --knn_recall run),
with phase 41's times or times at that call's shape.
The chain's train_point_seg run and phase 39's runs count with the train
paths (their widths are the default run's); phases 37 and 40 go into the
"slice" rows as paths of their own ("pointnet": serving's and the test
half's K1; "affine"), K3's and K4's by_call add the affine calls; phase
33's K1 launches go into K1's "slice" row by
call ("preprocess", "preprocess_cnn", timed by phase 34), its K6 launches
into K6's "by_path" ("preprocess_cnn"), and K6's row adds
"preprocess_cnn_calls", phase 34's times at those calls. K6's row
gives its stride-1 launches by path and role ("forward", a checkpoint's
recomputation included, and "dgrad", both strides' dgrad being stride-1
launches), the stride-2 row its stride-2 forwards by path, the wgrad
kernel's row its own (all and at stride 2). K1's, K2's, the transpose's,
K5's and the gather-reduce's rows add "slice": the PC-AE's and DSEG-AE's
launches by path (also DPSR-Net's and DG-SSM's), and for K1, K2 and K5 by
call (the wrapper's call key), each
call with its time, plain time, bound and library time (index_add_ for
K2): phase 3's, 6's or 9's where they time that call, else timed on
random inputs of its shape. The line before the last but one is a JSON object
describing the kernels (with each one's bound: the larger of its bytes over
3.35 TB/s and its operations over the 67 TFLOP/s float32 rate, and the time
of one PyTorch library call that computes the same function, where there
is one; the stream kernels' rows say "path": "probes"; K2's and K3's rows
add their time with a shared transpose and the transpose's time and bound;
K3's adds "by_call": the DGCNN train step's (32, 2048, 40, 64) and
DPSR-Net's (32, 1024, 20, 64), each with its launches;
the gather-reduce's row gives the numbers of its most launched call and
"by_call": each (want, dtype, shape) call's main-path launches, time, bound
and launches x (ms - bound ms); K4's row likewise, by the wrapper's call
names, each call with "device_ms" (its work on the card alone) and the
path that launches it: "train" for the
in-degrees from the transpose, "probes" for the histogram at 512 rows,
none for the histogram at 2048 rows, which no path runs now);
then the card's
name and power limit as nvidia-smi gives them; the last line is {"ok":
true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import csv
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from fissure_segmentation_tpu_torch.prof.timing import graph_ms, median_ms
from fissure_segmentation_tpu_torch.train.profile_step import card_line
from fissure_segmentation_tpu_torch.utils.profiling import device_rows

KNN_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/knn.cu"
FPS_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/fps.cu"
FPS_REPLACES = "fissure_segmentation_tpu/ops/pallas/fps.py:83"
KNN_REPLACES = "fissure_segmentation_tpu/ops/pallas/knn.py:158"
SCATTER_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/scatter.cu"
DW_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/depthwise.cu"
PALLAS_DW = "fissure_segmentation_tpu/ops/pallas/depthwise.py"
PALLAS_SCATTER = "fissure_segmentation_tpu/ops/pallas/scatter.py"
SCATTER_REPLACES = {"transpose": f"{PALLAS_SCATTER}:369",
                    "scatter_rows": f"{PALLAS_SCATTER}:369",
                    "scatter_routed": f"{PALLAS_SCATTER}:260",
                    "scatter_count": f"{PALLAS_SCATTER}:332"}
# K4's call on the probe path: P1's k_onehot, idx mod 512 of (32, 81 920)
PROBE_K4_CALL = "hist_32x81920_rows512"
GR_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/gather_reduce.cu"
GR_REPLACES = "scripts/prof/prof_fused_gather.py:64"
STREAM_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/stream.cu"
STREAM_REPLACES = {
    "stream_sum": "scripts/prof/prof_stream_bw.py:35",
    "stream_sum_async": "scripts/prof/prof_scatter_alt.py:147"}
STREAM_ALSO = {
    "stream_sum": ["scripts/prof/prof_scatter_floor.py:28",
                   "scripts/prof/prof_scatter_clean.py:65",
                   "scripts/prof/prof_scatter_alt.py:130"],
    "stream_sum_async": []}
SHAPE = (256, 256, 256)
TRAIN_ARGV = ["--ds", "synthetic", "--pts", "2048", "--k", "40", "--static",
              "--batch", "32", "--amp", "false", "--epochs", "3", "--fold",
              "0", "--train_only"]
AMP_TRAIN_ARGV = [a if a != "false" else "true" for a in TRAIN_ARGV]
# the default run of the entry point: no --static, no --train_only, --amp
# true (bf16)
DEFAULT_ARGV = ["--ds", "synthetic", "--fold", "0", "--epochs", "3", "--pts",
                "2048", "--k", "40", "--batch", "32"]
PT_TRAIN_ARGV = ["--model", "PointTransformer", "--ds", "synthetic", "--pts",
                 "2048", "--batch", "32", "--train_only", "--fold", "0",
                 "--epochs", "3"]
TRAIN_TOL = dict(rtol=2e-4, atol=2e-4)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12           # float32 outside the tensor cores
# least cycles of one dependent FPS step: the distance pass and a thread's
# running argmax (~80), two warp reductions (redux.sync + ballot, ~50
# each), a shared-memory store and two loads (~30 each) and a barrier
# (~30): an estimate, not a measurement
FPS_STEP_CYCLES = 330
REF_SEEDS = 10      # inputs the train-step reference may try
REF_MAX_FLIPS = 8   # more forward branches than this differing: a fault
ADAM_PINNED = 1e-6  # |g'| from which Adam's first step has a sure sign
ADAM_UNPINNED_SHARE = 0.01  # of the parameters, at most, below it
PT_UNPINNED_SHARE = 0.1     # PointTransformer (phase_pt_reference)
PT_EVAL_GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
EPS32 = 2.0 ** -24
CNN_SOFT_TOL = 5e-5  # phase_cnn_reference says why
# phase_bf16_reference says why
BF16_TOL = {"logits": 3e-2, "loss": 1e-2, "grad_rel_l2": 0.12,
            "stats_rel_l2": 2e-2}


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over the peak rate;
    returns (ms, "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


@functools.lru_cache(maxsize=1)
def _synthetic_ct_once() -> dict:
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    return make_synthetic_image_case(0, shape=SHAPE)


def synthetic_ct() -> dict:
    """The full-size synthetic case (`make_synthetic_image_case(0,
    shape=SHAPE)`), made once for the phases that serve or preprocess it
    (about 11 s on the card's host each time otherwise); a copy for each
    caller."""
    return copy.deepcopy(_synthetic_ct_once())


def _line(shape):
    """Points on a line, descending with the index: for the last point
    every key's distance falls with its index (each key enters its list)."""
    line = torch.linspace(1.0, -1.0, shape[1])[None, :, None]
    return (line * torch.ones(shape)).contiguous()


def phase_kernels(knn_cuda, knn_plain):
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)

    def uniform(*shape):
        return torch.rand(shape, generator=g) * 2 - 1
    lattice = torch.randint(0, 6, (3, 4096, 3), generator=g).float()
    lattice[:, :800] = -1.0
    masked = uniform(3, 8192, 3)
    masked[torch.rand((3, 8192), generator=g) < 1 / 3] = 1e6
    # DSEG-AE's padding graph: one fissure class of a case valid (about
    # 1/8 of the points), every other point moved to 1e6 (random_extend_
    # points); and a class of 30 points
    extend = uniform(1, 8000, 3)
    extend[torch.rand((1, 8000), generator=g) >= 0.117] = 1e6
    few = uniform(1, 8000, 3)
    few[:, 30:] = 1e6
    cases = {
        # name: (x, k, self_loop, timed)
        "dgcnn_graph_5x2048x3_k40": (uniform(5, 2048, 3), 40, False, True),
        "dgcnn_train_32x2048x3_k40": (uniform(32, 2048, 3), 40, False,
                                      True),
        "psr_normals_3x8192x3_k30": (uniform(3, 8192, 3), 30, True, True),
        "ragged_2x1000x3_k16": (uniform(2, 1000, 3), 16, False, False),
        "lattice_ties_3x4096x3_k30": (lattice, 30, True, False),
        # the selection's hard cases
        "descending_2x2048x3_k40": (_line((2, 2048, 3)), 40, False, False),
        "all_equal_2x2048x3_k40": (torch.full((2, 2048, 3), 0.25), 40,
                                   False, False),
        "masked_normals_3x8192x3_k30": (masked, 30, True, False),
        "kk1_2x300x3": (uniform(2, 300, 3), 1, True, False),
        "kk32_2x300x3": (uniform(2, 300, 3), 32, True, False),
        "kk33_2x300x3": (uniform(2, 300, 3), 33, True, False),
        "kk64_2x300x3": (uniform(2, 300, 3), 64, True, False),
        "kk128_1x700x3": (uniform(1, 700, 3), 128, True, False),
        "n_eq_kk_2x41x3_k40": (uniform(2, 41, 3), 40, False, False),
        "tiled_1x20000x3_k16": (uniform(1, 20000, 3), 16, False, False),
        # the PC-AE's and DSEG-AE's calls (timed under the wrapper's call
        # key too, for the kernels line's by-call rows)
        "pcae_32x1024x3_k20": (uniform(32, 1024, 3), 20, True, True),
        "dseg_dynamic_5x2048x3_k40": (uniform(5, 2048, 3), 40, True, True),
        "extend_1e6_1x8000x3_k1": (extend, 1, False, True),
        "extend_1e6_30valid_1x8000x3_k1": (few, 1, False, False),
    }
    max_err, timings = 0.0, {}
    for name, (x, k, self_loop, timed) in cases.items():
        x = x.to(dev)
        i_k, d_k = knn_cuda(x, k, self_loop)
        torch.cuda.synchronize()
        i_p, d_p = knn_plain(x, k, self_loop)
        torch.cuda.synchronize()
        if not (torch.equal(i_k, i_p) and torch.equal(d_k, d_p)):
            raise AssertionError(f"K1 {name}: kernel differs from plain "
                                 f"({(i_k != i_p).sum().item()} indices)")
        err = (d_k - d_p).abs().max().item()
        max_err = max(max_err, err)
        line = f"K1 {name}: kernel == plain (indices, distances)"
        if timed:
            t_k = median_ms(lambda: knn_cuda(x, k, self_loop))
            t_p = median_ms(lambda: knn_plain(x, k, self_loop))
            b, n, c = x.shape
            kk = k if self_loop else k + 1
            # read x once, write idx and dist; c subs, c muls, c adds a pair
            bound, by = bound_ms(x.numel() * 4 + b * n * kk * 8,
                                 3 * c * b * n * n)
            timings[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                             "bound_by": by, "library_ms": None,
                             "call": f"{b}x{n}x{c}_kk{kk}"}
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), "
                     f"bound {bound:.4f} ms ({by})")
        print(line, flush=True)
    return max_err, timings


def biased_model(model, case, shape):
    """bench.py's class bias: keypoints in a z-band around each synthetic
    fissure sheet, on its lung's side, get +50 on that class's logit."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        sample_fissure_surface
    from fissure_segmentation_tpu_torch.serving import kpts_to_grid
    rng = np.random.default_rng(11)
    scale = np.array(shape[::-1], np.float32) - 1
    bands = []
    for c in (1, 2, 3):
        s = sample_fissure_surface(case["surface_params"], c, 2000, rng)
        gc = kpts_to_grid(torch.from_numpy((s * scale).astype(np.float32)),
                          shape).numpy()
        bands.append((float(gc[:, 2].mean()), float(2 * gc[:, 2].std() + 0.02),
                      float(np.sign(gc[:, 0].mean()))))

    def apply(x):
        logits = model(x)
        z, xg = x[..., 2], x[..., 0]
        bias = torch.zeros_like(logits)
        for c, (mu, w, side) in enumerate(bands, start=1):
            bias[..., c] = 50.0 * ((z - mu).abs() < w) * (xg * side > 0)
        return logits + bias
    return apply


def check_result(res, shape, what: str):
    if len(res.kpts) == 0:
        raise AssertionError(f"{what}: no valid keypoints")
    for c, (tris, valid) in enumerate(res.meshes, start=1):
        if int(valid.sum()) == 0:
            raise AssertionError(f"{what}: class {c} has no valid triangles")
        if tris.ndim != 3 or tris.shape[1:] != (3, 3) or \
                not np.isfinite(tris[valid]).all():
            raise AssertionError(f"{what}: class {c} triangles malformed")
    if res.labelmap.shape != shape or not (res.labelmap > 0).any():
        raise AssertionError(f"{what}: empty or misshapen labelmap")


def phase_slice(knn_cuda, card: str):
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    t0 = time.perf_counter()
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = DGCNNSeg(k=40, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)
    print(f"slice: synthetic {SHAPE} case made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run(seed):
        return segment_case(vol, mask, apply, torch.Generator().manual_seed(seed),
                            center_x=SHAPE[2] / 2)

    t0 = time.perf_counter()
    check_result(run(1), SHAPE, "warm-up case")
    print(f"slice: warm-up case {time.perf_counter() - t0:.3f} s", flush=True)

    n_cases = 10
    knn_cuda.launches = gather_reduce.launches = 0
    gather_reduce.calls.clear()
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"case {i}")
    launches = {"knn": knn_cuda.launches,
                "gather_reduce": gather_reduce.launches}
    if launches["knn"] < 11 * n_cases:
        raise AssertionError(f"K1 launched {launches['knn']} times in "
                             f"{n_cases} cases; the path needs >= "
                             f"{11 * n_cases}")
    if launches["gather_reduce"] < 20 * n_cases:
        raise AssertionError(f"gather_reduce launched "
                             f"{launches['gather_reduce']} times in "
                             f"{n_cases} cases; the path needs >= "
                             f"{20 * n_cases}")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}, labelmap voxels per class "
          f"{np.bincount(res.labelmap.ravel(), minlength=4)[1:].tolist()}",
          flush=True)
    print(f"slice: launches in {n_cases} timed cases: {launches}",
          flush=True)
    print(f"slice: {statistics.median(times):.4f} s/case median of "
          f"{[round(t, 4) for t in times]} on {card}", flush=True)
    return launches


def phase_reference(card: str):
    """Small input: the slice on the card (kernels) vs on the CPU (plain
    versions), same weights, same subsets."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    shape = (128, 128, 128)
    case = make_synthetic_image_case(1, shape=shape)
    model = DGCNNSeg(k=40, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(3)).eval()
    cfg = dict(max_kpts=4000, sample_points=512, n_runs_min=8,
               subset_batch=2, grid_res=(32, 32, 32), center_x=shape[2] / 2)
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        out[dev] = segment_case(case["image"], case["lung_mask"],
                                biased_model(m, case, shape),
                                torch.Generator().manual_seed(4), device=dev,
                                **cfg)
    a, b = out["cuda"], out["cpu"]
    if not np.array_equal(a.kpts, b.kpts):
        raise AssertionError("reference: keypoints differ card vs CPU")
    agree = float((a.labels == b.labels).mean())
    if agree < 0.99:
        raise AssertionError(f"reference: labels agree on {agree:.4f} only")
    for c, ((t1, v1), (t2, v2)) in enumerate(zip(a.meshes, b.meshes), 1):
        n1, n2 = int(v1.sum()), int(v2.sum())
        if abs(n1 - n2) > max(8, 0.05 * max(n1, n2)):
            raise AssertionError(f"reference: class {c} triangles {n1} vs {n2}")
        x, y = a.labelmap == c, b.labelmap == c
        if x.any() or y.any():
            dice = 2 * (x & y).sum() / (x.sum() + y.sum())
            if dice < 0.9:
                raise AssertionError(f"reference: class {c} Dice {dice:.3f}")
    print(f"reference: {shape} card vs CPU: keypoints equal "
          f"({len(a.kpts)}), labels agree {agree:.4f}, triangles per class "
          f"{[int(v.sum()) for _, v in a.meshes]} vs "
          f"{[int(v.sum()) for _, v in b.meshes]}", flush=True)


def _bound(ks, idx, absg, n_rows):
    """Twice the worst-case rounding of a sequential float32 sum, per
    output element: (deg - 1) * 2^-24 * sum|x| for each of the two sums."""
    deg = ks.scatter_count_plain(idx, n_rows)[..., None]
    return 2 * deg * EPS32 * ks.scatter_rows_plain(idx, absg, n_rows)


def _check_scatter(name, got, again, want, bound=None):
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches differ")
    err = (got - want).abs()
    if bound is None:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain")
    elif not bool((err <= bound).all()):
        raise AssertionError(f"{name}: kernel off the plain version by "
                             f"{err.max().item()} (bound exceeded)")
    return err.max().item()


def _transpose_cases(dev, g):
    """The transpose's hard cases: {name: ((B, E) int32 targets, n_rows)}."""
    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    hub = draw(0, 2000, (2, 5000))
    hub[:, ::4] = 7                                 # in-degree 1250
    dropped = draw(-40, 1040, (2, 7000))            # below 0 and past 999
    return {"hub_2x5000_rows2000": (hub, 2000),
            "one_row_3x4000": (torch.full((3, 4000), 5, dtype=torch.int32,
                                          device=dev), 10),
            "empty_rows_2x3000_rows4096": (draw(0, 50, (2, 3000)), 4096),
            "dropped_2x7000_rows1000": (dropped, 1000),
            "n_rows_1_4x999": (draw(-1, 2, (4, 999)), 1),
            # counters too many for shared memory: kept in device memory
            "many_rows_2x5000_rows60000": (draw(-5, 60005, (2, 5000)), 60000),
            "no_edges_2x0": (draw(0, 1, (2, 0)), 10)}


def phase_scatter(ks, knn_cuda):
    """The graph transpose, K2-K4 against their plain versions at the train
    step's shapes and a ragged shape (the transpose also at its hard
    cases); K2 and K3 with their own transpose and with a shared one.
    Returns {kernel: (max_abs_err, {shape: timings})}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, n, k, c = 32, 2048, 40, 64
    graph, _ = knn_cuda(torch.rand((b, n, 3), generator=g, device=dev) * 2
                        - 1, k)                       # the step's K1 graph
    graph = graph.contiguous()
    ragged = torch.randint(0, 1000, (3, 1000, 13), generator=g, device=dev,
                           dtype=torch.int32)
    ragged[:, ::17, 0] = 1007                         # dropped targets
    ragged[:, 3::19, 1] = -2
    ragged[:, :, 2] = 0                               # a hub row
    out = {"transpose": [0.0, {}], "scatter_rows": [0.0, {}],
           "scatter_routed": [0.0, {}], "scatter_count": [0.0, {}]}

    def record(kernel, shape, err, fn_k, fn_p, work=None, fn_lib=None,
               fn_shared=None):
        """`work`: (bytes, operations) of the function, for its bound;
        `fn_lib`: one PyTorch library call computing it, or None;
        `fn_shared`: the kernel given the caller's transpose."""
        out[kernel][0] = max(out[kernel][0], err)
        line = f"{kernel} {shape}: max |kernel - plain| {err:.3g}"
        row = None
        if fn_k is not None:
            t_k, t_p = median_ms(fn_k), median_ms(fn_p)
            t_l = None if fn_lib is None else median_ms(fn_lib)
            bound, by = bound_ms(*work)
            row = out[kernel][1][shape] = {
                "ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                "bound_by": by, "library_ms": t_l}
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
                     f"{'none' if t_l is None else f'{t_l:.4f} ms'} "
                     f"(median), bound {bound:.4f} ms ({by})")
            if fn_shared is not None:
                row["shared_ms"] = median_ms(fn_shared)
                line += (f"; with the shared transpose {row['shared_ms']:.4f}"
                         " ms")
        print(line, flush=True)
        return row

    for name, (idx2, nn_) in _transpose_cases(dev, g).items():
        got = ks.transpose(idx2, nn_)
        want = ks.transpose_plain(idx2, nn_)
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            raise AssertionError(f"transpose {name}: kernel != plain")
        print(f"transpose {name}: kernel == plain (order, ptr)", flush=True)
    for tag, idx3, timed in (("path", graph, True), ("ragged", ragged, False)):
        bb, nn_, kk = idx3.shape
        idx2 = idx3.reshape(bb, nn_ * kk)
        tr = ks.transpose(idx2, nn_)
        want = ks.transpose_plain(idx2, nn_)
        if not all(torch.equal(a, w) for a, w in zip(tr, want)):
            raise AssertionError(f"transpose {tag}: kernel != plain")
        record("transpose", f"{tag}_{bb}x{nn_ * kk}_rows{nn_}", 0.0,
               (lambda: ks.transpose(idx2, nn_)) if timed else None,
               lambda: ks.transpose_plain(idx2, nn_),
               # read idx, write order and ptr (int32); no arithmetic
               (idx2.numel() * 8 + (bb * nn_ + 1) * 4, 0))
        for dtype in (torch.float32, torch.bfloat16):
            pay = torch.randn((bb, nn_ * kk, c), generator=g,
                              device=dev).to(dtype)
            got = ks.scatter_rows(idx2, pay, nn_)
            again = ks.scatter_rows(idx2, pay, nn_)
            if not torch.equal(ks.scatter_rows(idx2, pay, nn_, tr), got):
                raise AssertionError("K2: the shared transpose changes it")
            want = ks.scatter_rows_plain(idx2, pay, nn_)
            err = _check_scatter("K2", got, again, want,
                                 _bound(ks, idx2, pay.float().abs(), nn_))
            shape = f"{tag}_{bb}x{nn_ * kk}x{c}_{str(dtype)[6:]}"
            flat = ks._flat_targets(idx2, nn_)
            acc = torch.zeros((bb * nn_ + 1, c), device=dev)
            pay2 = pay.reshape(-1, c).float()
            record("scatter_rows", shape, err,
                   (lambda: ks.scatter_rows(idx2, pay, nn_)) if timed else None,
                   lambda: ks.scatter_rows_plain(idx2, pay, nn_),
                   # read idx and the payload, write (B, rows, C) f32; one
                   # add per payload element
                   (idx2.numel() * 4 + pay.numel() * pay.element_size()
                    + bb * nn_ * c * 4, pay.numel()),
                   lambda: acc.index_add_(0, flat, pay2),
                   lambda: ks.scatter_rows(idx2, pay, nn_, tr))
        kstar = torch.randint(0, kk, (bb, nn_, c), generator=g, device=dev,
                              dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            s = torch.randn((bb, nn_, c), generator=g, device=dev).to(dtype)
            p = torch.randn((bb, nn_, c), generator=g, device=dev).to(dtype)
            err = _check_routed(ks, idx3, kstar, s, p, nn_, tr)
            record("scatter_routed",
                   f"{tag}_{bb}x{nn_}x{kk}x{c}_{str(dtype)[6:]}", err,
                   (lambda: ks.scatter_routed(idx3, kstar, s, p, nn_))
                   if timed else None,
                   lambda: ks.scatter_routed_plain(idx3, kstar, s, p, nn_),
                   # read idx, kstar, s, p; write (B, rows, 2C) f32; per
                   # edge and channel two adds
                   (idx3.numel() * 4 + bb * nn_ * c * 4
                    + 2 * s.numel() * s.element_size() + bb * nn_ * 2 * c
                    * 4, 2 * idx3.numel() * c),
                   fn_shared=lambda: ks.scatter_routed(idx3, kstar, s, p,
                                                       nn_, tr))
        err = _check_count(ks, idx2, nn_, tr)
        if timed:
            _record_count(ks, record, idx2, nn_, tr, err)
    # the PC-AE encoder's gather backward: K2 on its K1 graph (32, 1024,
    # k = 20, self-loop) at every layer's width, f32 payloads
    pc_graph, _ = knn_cuda(torch.rand((32, 1024, 3), generator=g,
                                      device=dev) * 2 - 1, 20, True)
    idx2 = pc_graph.reshape(32, 1024 * 20).contiguous()
    tr = ks.transpose(idx2, 1024)
    if not all(torch.equal(a, w) for a, w in
               zip(tr, ks.transpose_plain(idx2, 1024))):
        raise AssertionError("transpose pcae: kernel != plain")
    record("transpose", "pcae_32x20480_rows1024", 0.0,
           lambda: ks.transpose(idx2, 1024),
           lambda: ks.transpose_plain(idx2, 1024),
           (idx2.numel() * 8 + (32 * 1024 + 1) * 4, 0))
    flat = ks._flat_targets(idx2, 1024)
    for c_ in (64, 128, 256):
        pay = torch.randn((32, 1024 * 20, c_), generator=g, device=dev)
        got = ks.scatter_rows(idx2, pay, 1024, tr)
        err = _check_scatter("K2 pcae", got,
                             ks.scatter_rows(idx2, pay, 1024, tr),
                             ks.scatter_rows_plain(idx2, pay, 1024),
                             _bound(ks, idx2, pay.abs(), 1024))
        acc = torch.zeros((32 * 1024 + 1, c_), device=dev)
        pay2 = pay.reshape(-1, c_)
        row = record(
            "scatter_rows", f"32x20480x{c_}_rows1024_float32", err,
            lambda: ks.scatter_rows(idx2, pay, 1024),
            lambda: ks.scatter_rows_plain(idx2, pay, 1024),
            (idx2.numel() * 4 + pay.numel() * 4 + 32 * 1024 * c_ * 4,
             pay.numel()),
            lambda: acc.index_add_(0, flat, pay2),
            lambda: ks.scatter_rows(idx2, pay, 1024, tr))
        row["call"] = f"32x20480x{c_}_rows1024_float32"
    # K4's histogram at P1's 512 rows (idx mod 512: in-degree 160), then
    # both K4 kernels at their hard cases
    lo = torch.randint(0, n, (b, n * k), generator=g, device=dev,
                       dtype=torch.int32) % 512
    err = _check_count(ks, lo, 512, ks.transpose(lo, 512))
    _record_count(ks, record, lo, 512, None, err)
    for name, (idx2, nn_) in _count_cases(dev, g).items():
        err = _check_count(ks, idx2, nn_, ks.transpose(idx2, nn_))
        out["scatter_count"][0] = max(out["scatter_count"][0], err)
        print(f"scatter_count {name} {tuple(idx2.shape)} rows {nn_}: "
              "histogram == plain, from the transpose == plain", flush=True)
    for name, (idx3, c, dtype, kmode) in _routed_cases(ks, dev, g).items():
        bb, nn_, kk = idx3.shape
        kstar = torch.randint(0, kk, (bb, nn_, c), generator=g, device=dev,
                              dtype=torch.int32)
        if kmode == "edges":          # only the first and the last slot
            kstar = torch.where(kstar % 2 == 0, 0, kk - 1).to(torch.int32)
        s = torch.randn((bb, nn_, c), generator=g, device=dev).to(dtype)
        p = torch.randn((bb, nn_, c), generator=g, device=dev).to(dtype)
        tr = ks.transpose(idx3.reshape(bb, nn_ * kk), nn_)
        err = _check_routed(ks, idx3, kstar, s, p, nn_, tr)
        out["scatter_routed"][0] = max(out["scatter_routed"][0], err)
        print(f"scatter_routed {name} {bb}x{nn_}x{kk}x{c} "
              f"{str(dtype)[6:]}: max |kernel - plain| {err:.3g}",
              flush=True)
    torch.cuda.synchronize()
    return out


def _check_count(ks, idx2, n_rows, tr) -> float:
    """Both K4 kernels (the histogram of idx; the in-degrees from the
    transpose's row offsets) equal to plain, two launches of each
    bit-equal; returns max |kernel - plain| (0)."""
    want = ks.scatter_count_plain(idx2, n_rows)
    err = 0.0
    for name, t in (("K4 histogram", None), ("K4 from the transpose", tr)):
        got = ks.scatter_count(idx2, n_rows, t)
        again = ks.scatter_count(idx2, n_rows, t)
        err = max(err, _check_scatter(name, got, again, want))
    return err


def _record_count(ks, record, idx2, n_rows, tr, err) -> None:
    """K4 timed by call under the wrapper's call names: the histogram
    ("hist_{B}x{E}_rows{n_rows}", against bincount) and, given `tr`, the
    in-degrees from its row offsets ("ptr_{B}x{n_rows}", against
    torch.diff, whose int32 differences are the same counts)."""
    bb, e = idx2.shape
    flat = ks._flat_targets(idx2, n_rows)
    calls = [(f"hist_{bb}x{e}_rows{n_rows}",
              lambda: ks.scatter_count(idx2, n_rows),
              lambda: ks.scatter_count_plain(idx2, n_rows),
              # read idx, write (B, rows) f32; one add per edge
              (idx2.numel() * 4 + bb * n_rows * 4, idx2.numel()),
              lambda: torch.bincount(flat, minlength=bb * n_rows + 1))]
    if tr is not None:
        ptr = tr[1]
        calls.append((f"ptr_{bb}x{n_rows}",
                      lambda: ks.scatter_count(idx2, n_rows, tr),
                      lambda: ks.count_from_ptr_plain(ptr, bb, n_rows),
                      # read ptr, write (B, rows) f32; one subtraction a row
                      (bb * n_rows * 8 + 4, bb * n_rows),
                      lambda: torch.diff(ptr)))
    for key, fn_k, fn_p, work, fn_lib in calls:
        row = record("scatter_count", key, err, fn_k, fn_p, work, fn_lib)
        # K4's launch is shorter than its wrapper's host time: "ms" is the
        # wrapper back to back, as every row times its kernel, and
        # "device_ms" its work on the card alone (CUDA-graph replays)
        row["device_ms"] = graph_ms(fn_k)
        print(f"scatter_count {key}: on the card {row['device_ms']:.4f} ms "
              "(CUDA-graph replays)", flush=True)


def _count_cases(dev, g):
    """K4's hard cases: {name: ((B, E) int32 targets, n_rows)}. Targets
    dropped on both sides, a hub, n_rows = 1, B = 1 (one cluster of 8
    blocks), B = 22 (clusters of 6), B = 132 (clusters of one block), E no
    multiple of 4, idx off a 16-byte boundary, 51 200 rows (the most
    counters shared memory holds: clusters of 8 blocks of 200 KB), 60 000
    rows (the counters in device memory)."""
    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)
    hub = draw(0, 2000, (2, 5000))
    hub[:, ::4] = 7                                 # in-degree 1250
    return {"dropped_2x7001_rows1000": (draw(-40, 1040, (2, 7001)), 1000),
            "hub_2x5000_rows2000": (hub, 2000),
            "n_rows_1_4x999": (draw(-1, 2, (4, 999)), 1),
            "b_1_1x81920_rows2048": (draw(0, 2048, (1, 81920)), 2048),
            "b_22_22x4097_rows700": (draw(-3, 703, (22, 4097)), 700),
            "b_132_132x4097_rows700": (draw(-3, 703, (132, 4097)), 700),
            "unaligned_5x4003_rows700":
                (draw(-3, 703, (5 * 4003 + 1,))[1:].view(5, 4003), 700),
            "smem_rows_2x60000_rows51200": (draw(-5, 51205, (2, 60000)),
                                            51200),
            "many_rows_2x5000_rows60000": (draw(-5, 60005, (2, 5000)),
                                           60000)}


def _check_k4_route(ks, what: str) -> dict:
    """The DGCNN train path since the last reset ran K4 only from the
    shared transpose (count_from_ptr), never the histogram; returns its
    calls."""
    calls = dict(ks.scatter_count.calls)
    if not any(k.startswith("ptr_") for k in calls) or any(
            k.startswith("hist_") for k in calls):
        raise AssertionError(f"{what}: K4 not only from the transpose: "
                             f"{calls}")
    return calls


def k4_by_call(calls: dict, timings: dict, paths: dict) -> dict:
    """K4's launches priced by call: every timed call with its main-path
    launches (0 where no path runs it), its own time and bound, and
    launches x (ms - bound ms). A main-path call that phase 6 did not time
    is a fault."""
    untimed = set(calls) - set(timings)
    if untimed:
        raise AssertionError(f"scatter_count: calls {untimed} not timed")
    out = {}
    for key, t in sorted(timings.items()):
        n = calls.get(key, 0)
        out[key] = {"launches": n, "path": paths.get(key),
                    "ms": t["ms"], "device_ms": t["device_ms"],
                    "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": t["library_ms"],
                    "gap_ms": n * (t["ms"] - t["bound_ms"])}
    return out


def _check_routed(ks, idx3, kstar, s, p, n_rows, tr) -> float:
    """K3 within its rounding bound of plain, two launches bit-equal, and
    the caller's transpose changing nothing; returns max |kernel - plain|."""
    bb, nn_, kk = idx3.shape
    got = ks.scatter_routed(idx3, kstar, s, p, n_rows)
    again = ks.scatter_routed(idx3, kstar, s, p, n_rows)
    if not torch.equal(ks.scatter_routed(idx3, kstar, s, p, n_rows, tr),
                       got):
        raise AssertionError("K3: the shared transpose changes it")
    want = ks.scatter_routed_plain(idx3, kstar, s, p, n_rows)
    deg = ks.scatter_count_plain(idx3.reshape(bb, nn_ * kk), n_rows)[..., None]
    bound = 2 * deg * EPS32 * ks.scatter_routed_plain(
        idx3, kstar, s.float().abs(), p.float().abs(), n_rows)
    return _check_scatter("K3", got, again, want, bound)


def _routed_cases(ks, dev, g):
    """K3's hard cases: {name: ((B, N, K) int32 graph, C, payload dtype,
    kstar "random" or "edges")}. C off the staged slice; N where the staged
    slices just fit in shared memory and just do not, and K above 255 (both
    the kernel that reads device memory); a hub row; kstar at 0 and K - 1."""
    f32, bf16 = torch.float32, torch.bfloat16

    def draw(b, n, k):
        return torch.randint(0, n, (b, n, k), generator=g, device=dev,
                             dtype=torch.int32)
    hub = draw(2, 2000, 40)
    hub.view(2, -1)[:, ::64] = 7                 # in-degree 1250
    nf, nb = (ks.ROUTED_STAGED_MAX_N[t] for t in (f32, bf16))
    return {"c33": (draw(2, 500, 40), 33, f32, "random"),
            "c40_bf16": (draw(2, 500, 40), 40, bf16, "random"),
            "c36_bf16": (draw(2, 500, 40), 36, bf16, "random"),
            "c200": (draw(2, 500, 40), 200, f32, "random"),
            "c256_bf16": (draw(2, 500, 40), 256, bf16, "random"),
            "fits_f32": (draw(1, nf, 40), 64, f32, "random"),
            "spills_f32": (draw(1, nf + 1, 40), 64, f32, "random"),
            "fits_bf16": (draw(1, nb, 40), 64, bf16, "random"),
            "spills_bf16": (draw(1, nb + 1, 40), 64, bf16, "random"),
            "k300": (draw(2, 400, ks.ROUTED_STAGED_MAX_K + 45), 16, f32,
                     "random"),
            "hub": (hub, 64, f32, "random"),
            "hub_bf16": (hub, 64, bf16, "random"),
            "kstar_0_and_last": (draw(2, 700, 40), 64, f32, "edges"),
            "kstar_0_and_last_bf16": (draw(2, 700, 40), 64, bf16, "edges")}


def _wrappers(ks, knn_cuda) -> dict:
    """Every kernel wrapper of the port, by the name its counts go under."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import \
        depthwise_conv3_cuda
    from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce
    from fissure_segmentation_tpu_torch.kernels.stream import (
        stream_sum, stream_sum_async)
    from fissure_segmentation_tpu_torch.kernels.depthwise import \
        depthwise_conv3_wgrad_cuda
    from fissure_segmentation_tpu_torch.kernels.approx_topk import (
        bin_extrema, select_rows)
    return {"knn": knn_cuda, "transpose": ks.transpose,
            "scatter_rows": ks.scatter_rows,
            "scatter_routed": ks.scatter_routed,
            "scatter_count": ks.scatter_count, "fps": fps_cuda,
            "depthwise_conv3": depthwise_conv3_cuda,
            "depthwise_wgrad": depthwise_conv3_wgrad_cuda,
            "gather_reduce": gather_reduce, "stream_sum": stream_sum,
            "stream_sum_async": stream_sum_async, "bin_extrema": bin_extrema,
            "select_rows": select_rows}


def _counts(ks, knn_cuda):
    return {k: fn.launches for k, fn in _wrappers(ks, knn_cuda).items()}


def _zero(fn):
    """Set a wrapper's launch count, and its count by role where it keeps
    one, to 0."""
    fn.launches = 0
    for role in getattr(fn, "roles", {}):
        fn.roles[role] = 0


def _reset(ks, knn_cuda):
    wrappers = _wrappers(ks, knn_cuda)
    for fn in wrappers.values():
        _zero(fn)
    for name in ("gather_reduce", "scatter_count", "knn", "scatter_rows",
                 "fps", "scatter_routed", "bin_extrema", "select_rows"):
        wrappers[name].calls.clear()


def _gr_calls(ks, knn_cuda) -> dict:
    """The gather-reduce's launches by call since the last reset."""
    return dict(_wrappers(ks, knn_cuda)["gather_reduce"].calls)


def _read_history(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return [float(r["train_total_loss"]) for r in rows]


def phase_train(ks, knn_cuda, card: str):
    """The training slice at full width through the port's entry point,
    then timed warm steps in both routings. Counts are reset before and
    read after; returns them with the timings."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       export_jax_variables,
                                                       load_model)
    from fissure_segmentation_tpu_torch.ops.fused_edge import (
        CUDA_DEFAULT, fused_edge_enabled)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        WARM, canonical_data, make_step, time_steps)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        _reset(ks, knn_cuda)
        t0 = time.perf_counter()
        if train_point_seg.main(TRAIN_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("train: the entry point failed")
        counts["entry"] = _counts(ks, knn_cuda)
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        if len(hist) != 3 or not np.isfinite(hist).all():
            raise AssertionError(f"train: loss history {hist}")
        model = load_model(os.path.join(fold, "model.pt"), DGCNNSeg)
        stats = export_jax_variables(model)["batch_stats"]
        still = [name for name, leaf in _leaves(stats)
                 if np.array_equal(leaf, np.zeros_like(leaf))
                 or np.array_equal(leaf, np.ones_like(leaf))]
        if still:
            raise AssertionError(f"train: running statistics never moved: "
                                 f"{still}")
        print(f"train: entry point (3 epochs, fold 0, default routing "
              f"{'fused' if fused_edge_enabled('cuda') else 'unfused'}) in "
              f"{time.perf_counter() - t0:.1f} s; loss history {hist}; "
              f"launches {counts['entry']}", flush=True)

        ds, loss_fn = canonical_data()
        timing = {}
        for fused in ("0", "1"):
            os.environ["FSEG_FUSED_EDGE"] = fused
            step = make_step(ds, loss_fn, tmp)
            for _ in range(WARM):
                step()
            before = _counts(ks, knn_cuda)
            ms, peak, losses = time_steps(step)
            after = _counts(ks, knn_cuda)
            if not torch.isfinite(torch.stack(losses)).all():
                raise AssertionError(f"train: non-finite loss ({fused})")
            name = "fused" if fused == "1" else "unfused"
            launched = {k: after[k] - before[k] for k in after}
            timing[name] = {
                "ms_per_step": ms, "clouds_per_s": 32e3 / ms,
                "peak_bytes": peak, "launches_10_steps": launched}
            print(f"train: {name} step {ms:.2f} ms ({32e3 / ms:.1f} "
                  f"clouds/s), peak {peak / 2 ** 30:.2f} GiB, launches in "
                  f"10 steps {launched} on {card}", flush=True)
        os.environ.pop("FSEG_FUSED_EDGE")
    counts["total"] = _counts(ks, knn_cuda)
    if timing["unfused"]["launches_10_steps"]["scatter_rows"] < 10 or \
            timing["fused"]["launches_10_steps"]["scatter_rows"] < 10:
        raise AssertionError("train: K2 did not launch in every step")
    for name in ("unfused", "fused"):  # one transpose a step, shared
        if timing[name]["launches_10_steps"]["transpose"] != 10:
            raise AssertionError(f"train: {name}: not one transpose a step")
    for name in ("scatter_routed", "scatter_count", "gather_reduce"):
        if timing["fused"]["launches_10_steps"][name] < 10:
            raise AssertionError(f"train: {name} did not launch in every "
                                 "fused step")
    counts["k4_calls"] = _check_k4_route(ks, "train")
    faster = min(timing, key=lambda r: timing[r]["ms_per_step"])
    print(f"train: faster routing on this card: {faster} (CUDA default in "
          f"ops/fused_edge.py: {'fused' if CUDA_DEFAULT else 'unfused'})",
          flush=True)
    return counts, timing


def _leaves(tree, path=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", tree[k]


def _close(name, got, want, **tol):
    if not np.allclose(got, want, **tol):
        raise AssertionError(f"train reference: {name} differs card vs CPU "
                             f"by {np.abs(got - want).max():.3g}")


class Conv3dRecorder(TorchFunctionMode):
    """Counts the F.conv3d calls (cuDNN's convolutions) by (groups, kernel
    size) while active."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.nn.functional.conv3d:
            groups = args[6] if len(args) > 6 else kwargs.get("groups", 1)
            key = (groups, tuple(args[1].shape[2:]))
            self.calls[key] = self.calls.get(key, 0) + 1
        return func(*args, **kwargs)


class BranchRecorder(TorchFunctionMode):
    """Records the branch each decision of a forward takes: the condition
    of every three-argument torch.where (LeakyReLU, the fused core's slot
    choice and tail), the extremal mask of every amax (max over k, global
    max-pool), every argmax/argmin, and the first extremal slots the fused
    core's gather-reduce returns (its routed slots; ops/fused_edge.py's
    `gather_reduce` is wrapped while active, and the plain version's own
    torch calls inside it are not recorded, so the card's kernel and the
    CPU's plain version record the same)."""

    def __init__(self):
        super().__init__()
        self.branches = []
        self._inside = False

    def __enter__(self):
        from fissure_segmentation_tpu_torch.ops import fused_edge as fe
        self._fe, self._saved = fe, fe.gather_reduce

        def gather_reduce(a, idx, want):
            self._inside = True
            try:
                out = self._saved(a, idx, want)
            finally:
                self._inside = False
            if want == "all":
                self.branches += [out[2].cpu(), out[3].cpu()]
            return out
        fe.gather_reduce = gather_reduce
        return super().__enter__()

    def __exit__(self, *exc):
        self._fe.gather_reduce = self._saved
        return super().__exit__(*exc)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        name = getattr(func, "__name__", "")
        if name == "where" and len(args) == 3:
            self.branches.append(args[0].detach().cpu())
        elif name == "amax":
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            x = args[0].detach()
            self.branches.append((x == x.amax(dim=dim, keepdim=True)).cpu())
        elif name in ("argmax", "argmin"):
            self.branches.append(out.detach().cpu())
        return out


def _reference_step(dev, model0, ds, cw, cfg, x, y):
    """One trainer step on `dev`; returns (model, loss, components, the
    forward's branches)."""
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.train.trainer import ModelTrainer
    trainer = ModelTrainer(copy.deepcopy(model0), ds,
                           get_loss_fn("nnunet", cw.to(dev)),
                           tempfile.gettempdir(), cfg, device=dev)
    rec = BranchRecorder()

    def enter(*_):
        rec.__enter__()

    def leave(*_):
        rec.__exit__(None, None, None)
    hooks = [trainer.model.register_forward_pre_hook(enter),
             trainer.model.register_forward_hook(leave)]
    loss, comps = trainer.train_step(x.to(dev), y.to(dev))
    for h in hooks:
        h.remove()
    return (trainer.model, float(loss),
            {k: float(v) for k, v in comps.items()}, rec.branches)


def _reference_model(seed, ds, dtype=None, dynamic=False):
    """DGCNNSeg(k=8, `dynamic`) with seeded weights and every BatchNorm offset drawn
    from ±[0.05, 0.1]. The offsets matter to the updated parameters: the
    loss gradient of SharedMLP_0's BatchNorm offset vanishes analytically
    (the global max passes its shift on to SharedMLP_1, whose BatchNorm
    removes it), and with a zero offset Adam's first step,
    lr * g' / (|g'| + eps) with g' = g + wd * p, would move it by up to lr
    in the direction of its rounding noise. A nonzero offset gives g' the
    sign of wd * p on both sides."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    model = DGCNNSeg(k=8, in_features=ds.n_features,
                     num_classes=ds.num_classes, dynamic=dynamic,
                     generator=torch.Generator().manual_seed(seed),
                     dtype=dtype)
    return _draw_bn_offsets(model, seed)


def _draw_bn_offsets(model, seed):
    """Every BatchNorm offset of `model` drawn from ±[0.05, 0.1]."""
    from fissure_segmentation_tpu_torch.models.blocks import BatchNorm
    g = torch.Generator().manual_seed(1000 + seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                size = torch.rand(m.bias.shape, generator=g)
                sign = torch.randint(0, 2, m.bias.shape, generator=g) * 2 - 1
                m.bias.copy_(sign * (0.05 + 0.05 * size))
    return model


def phase_train_reference():
    """One step at B=2, N=256, k=8 on the card (kernels) and on the CPU
    (plain versions), same weights (`_reference_model`), same batch, both
    routings.

    The loss and its components (rtol 1e-5) and the running statistics
    (2e-4) are continuous in the rounding and are held on every input
    tried. The gradient is not: where a float32 rounding puts one
    LeakyReLU input or one max on the other side of its decision, the
    gradient of that element changes by a finite amount. So the forward's
    branches are recorded on both sides (BranchRecorder) and compared: more
    than REF_MAX_FLIPS differing branches fail the phase (that is no
    rounding); an input with 1..REF_MAX_FLIPS is set aside, and the next
    seed's weights and batch are tried, up to REF_SEEDS. On the first input
    whose branches all agree:
      * every gradient leaf within 2e-4 card vs CPU;
      * every updated parameter within 2e-4 card vs CPU, but for those
        whose Adam input g' = g + wd * p has opposite signs on the two
        sides or a magnitude below ADAM_PINNED on either: Adam's first step
        is lr * g' / (|g'| + eps), about lr * sign(g'), so there float32
        rounding decides the step. They are counted and may be at most
        ADAM_UNPINNED_SHARE of the parameters;
      * every updated parameter, those included, within 2e-4 of the CPU's
        Adam applied to the card's gradients from the same start."""
    from fissure_segmentation_tpu_torch.data.dataset import PointDataset
    from fissure_segmentation_tpu_torch.data.store import sample_batch
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    ds = PointDataset(make_synthetic_dataset(3, n_points=600),
                      sample_points=256)
    store = ds.to_store(device="cuda")
    cw = torch.as_tensor(ds.get_class_weights())
    cfg = TrainConfig()
    for fused in ("0", "1"):
        os.environ["FSEG_FUSED_EDGE"] = fused
        route = "fused" if fused == "1" else "unfused"
        set_aside = []
        for seed in range(REF_SEEDS):
            model0 = _reference_model(seed, ds)
            x, y = sample_batch(
                store, torch.tensor([0, 2], device="cuda"), ds.sample_points,
                torch.Generator(device="cuda").manual_seed(100 + seed))
            m_g, l_g, c_g, br_g = _reference_step("cuda", model0, ds, cw,
                                                  cfg, x, y)
            m_c, l_c, c_c, br_c = _reference_step("cpu", model0, ds, cw,
                                                  cfg, x, y)
            _close("loss", l_g, l_c, rtol=1e-5, atol=0)
            for k in c_c:
                _close(k, c_g[k], c_c[k], rtol=1e-5, atol=0)
            v_g = dict(_leaves(export_jax_variables(m_g)))
            v_c = dict(_leaves(export_jax_variables(m_c)))
            for name in v_c:
                if name.startswith("batch_stats/"):
                    _close(name, v_g[name], v_c[name], **TRAIN_TOL)
            if [b.shape for b in br_g] != [b.shape for b in br_c]:
                raise AssertionError("train reference: the card's forward "
                                     "took other decisions than the CPU's")
            n_br = sum(b.numel() for b in br_c)
            flips = sum(int((a != b).sum()) for a, b in zip(br_g, br_c))
            if flips > REF_MAX_FLIPS:
                raise AssertionError(f"train reference: {flips} of {n_br} "
                                     "forward branches differ card vs CPU")
            g_g = dict(_leaves(export_jax_variables(m_g, grad=True)))
            g_c = dict(_leaves(export_jax_variables(m_c, grad=True)))
            worst = max(float(np.abs(g_g[k] - g_c[k]).max()) for k in g_c)
            if flips:
                set_aside.append((seed, flips, float(f"{worst:.3g}")))
                continue
            for name in g_c:
                _close(f"grad {name}", g_g[name], g_c[name], **TRAIN_TOL)
            adam = copy.deepcopy(model0)
            for p, q in zip(adam.parameters(), m_g.parameters()):
                p.grad = q.grad.detach().cpu()
            torch.optim.Adam(adam.parameters(), lr=cfg.lr,
                             weight_decay=cfg.weight_decay).step()
            want = dict(_leaves(export_jax_variables(adam)))
            start = dict(_leaves(export_jax_variables(model0)))
            n_params, unpinned, upd_gap = 0, 0, 0.0
            for name in g_c:
                _close(f"updated {name}", v_g[name], want[name], **TRAIN_TOL)
                wd_p = cfg.weight_decay * start[name]
                a, b = g_g[name] + wd_p, g_c[name] + wd_p
                free = (np.sign(a) != np.sign(b)) | \
                    (np.minimum(np.abs(a), np.abs(b)) < ADAM_PINNED)
                _close(f"updated {name}", v_g[name][~free],
                       v_c[name][~free], **TRAIN_TOL)
                if (~free).any():
                    upd_gap = max(upd_gap, float(np.abs(
                        v_g[name][~free] - v_c[name][~free]).max()))
                n_params += free.size
                unpinned += int(free.sum())
            if unpinned > ADAM_UNPINNED_SHARE * n_params:
                raise AssertionError(f"train reference: {unpinned} of "
                                     f"{n_params} Adam steps not pinned")
            print(f"train reference: {route} step, seed {seed} (set aside, "
                  "(seed, differing branches, max gradient gap): "
                  f"{set_aside}); {n_br} "
                  f"forward branches equal card vs CPU; loss {l_g:.7f} vs "
                  f"{l_c:.7f}; all {len(g_c)} gradient leaves within 2e-4 "
                  f"(max |diff| {worst:.3g}); updated parameters within "
                  f"2e-4 card vs CPU (max |diff| {upd_gap:.3g}) but "
                  f"{unpinned} of {n_params} whose Adam input is unpinned "
                  f"(opposite signs or below {ADAM_PINNED:g}); all within "
                  f"2e-4 of the CPU's Adam on the card's gradients; "
                  f"running statistics within 2e-4", flush=True)
            break
        else:
            raise AssertionError(f"train reference: no {route} input of "
                                 f"{REF_SEEDS} with equal branches: "
                                 f"{set_aside}")
    os.environ.pop("FSEG_FUSED_EDGE")

# ---- PointTransformer (K5) ---------------------------------------------------

def _max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def phase_fps(fps_cuda, fps_plain):
    """K5 against its plain version; returns (max index gap, {shape:
    timings with bound}). Beside the byte/operation bound each timed shape
    gets a latency estimate: m - 1 dependent steps, each at least
    FPS_STEP_CYCLES cycles at the card's highest SM clock."""
    dev = torch.device("cuda")
    step_s = FPS_STEP_CYCLES / _max_sm_clock_hz()
    g = torch.Generator().manual_seed(5)

    def uniform(*shape):
        return torch.rand(shape, generator=g) * 2 - 1
    lattice = torch.randint(0, 6, (2, 4096, 3), generator=g).float()
    cases = {
        # name: (points, m, valid share, timed)
        "pt_step_32x2048x3_m512": (uniform(32, 2048, 3), 512, 1.0, True),
        "pt_step_32x512x3_m128": (uniform(32, 512, 3), 128, 1.0, True),
        "pt_serve_5x2048x3_m512": (uniform(5, 2048, 3), 512, 1.0, True),
        "dseg_masked_1x20000x3_m1024": (uniform(1, 20000, 3), 1024, 0.35,
                                        True),
        # one fissure class of a synthetic case (8000 points, 11.7 %)
        "dseg_class_1x8000x3_m1024": (uniform(1, 8000, 3), 1024, 0.117,
                                      True),
        "ragged_3x1000x3_m250": (uniform(3, 1000, 3), 250, 0.8, False),
        "lattice_ties_2x4096x3_m300": (lattice, 300, 1.0, False),
        "c4_2x700x4_m100": (uniform(2, 700, 4), 100, 0.6, False),
        # the hard cases
        "all_equal_2x1000x3_m100": (torch.full((2, 1000, 3), 0.25), 100,
                                    1.0, False),
        "n1_3x1x3_m4": (uniform(3, 1, 3), 4, 1.0, False),
        "m_above_valid_2x500x3_m300": (uniform(2, 500, 3), 300, 0.3, False),
        "ragged_2x2047x3_m64": (uniform(2, 2047, 3), 64, 1.0, False),
        "ragged_1x1025x3_m100": (uniform(1, 1025, 3), 100, 0.9, False),
        "n32768_2x32768x3_m256": (uniform(2, 32768, 3), 256, 0.9, False),
        "c1_2x3000x1_m200": (uniform(2, 3000, 1), 200, 1.0, False),
        "c8_2x3000x8_m200": (uniform(2, 3000, 8), 200, 0.7, False),
        "c8_1x32768x8_m64": (uniform(1, 32768, 8), 64, 1.0, False),
    }
    max_err, timings = 0, {}
    for name, (x, m, share, timed) in cases.items():
        x = x.to(dev)
        valid = None
        if share < 1.0:
            valid = (torch.rand(x.shape[:2], generator=g) < share).to(dev)
        got = fps_cuda(x, m, valid)
        torch.cuda.synchronize()
        want = fps_plain(x, m, valid)
        torch.cuda.synchronize()
        max_err = max(max_err, (got.long() - want.long()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {name}: kernel differs from plain "
                                 f"({(got != want).sum().item()} indices)")
        line = f"K5 {name}: kernel == plain (indices)"
        if timed:
            t_k = median_ms(lambda: fps_cuda(x, m, valid))
            t_p = median_ms(lambda: fps_plain(x, m, valid), reps=3, inner=1,
                            warm=1)
            b, n, c = x.shape
            # read points and validity, write (B, m) int32; per step and
            # point c subs, c muls, c adds and the min
            bound, by = bound_ms(x.numel() * 4 + b * n + b * m * 4,
                                 (m - 1) * b * n * (3 * c + 1))
            latency = (m - 1) * step_s * 1e3
            timings[name] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                             "bound_by": by, "latency_estimate_ms": latency,
                             "library_ms": None, "call": f"{b}x{n}x{c}_m{m}"}
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms (median), "
                     f"bound {bound:.4f} ms ({by}), latency estimate "
                     f"{latency:.4f} ms; {m - 1} dependent steps: "
                     f"{t_k / (m - 1) * 1e3:.3f} us a step")
        print(line, flush=True)
    return max_err, timings


def phase_pt_slice(card: str):
    """The serving slice with PointTransformerSeg at full width; returns
    the kernel launches of the timed cases."""
    from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    from fissure_segmentation_tpu_torch.models import PointTransformerSeg
    from fissure_segmentation_tpu_torch.serving import segment_case
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = PointTransformerSeg(
        in_features=3, num_classes=4,
        generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)

    def run(seed):
        return segment_case(vol, mask, apply,
                            torch.Generator().manual_seed(seed),
                            center_x=SHAPE[2] / 2)

    t0 = time.perf_counter()
    check_result(run(1), SHAPE, "PT warm-up case")
    print(f"pt slice: warm-up case {time.perf_counter() - t0:.3f} s",
          flush=True)
    n_cases = 3
    fps_cuda.launches = knn_cuda.launches = 0
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"PT case {i}")
    launches = {"fps": fps_cuda.launches, "knn": knn_cuda.launches}
    if launches["fps"] < 40 * n_cases:
        raise AssertionError(f"K5 launched {launches['fps']} times in "
                             f"{n_cases} PT cases; the path needs >= "
                             f"{40 * n_cases}")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"pt slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}; launches in {n_cases} timed cases {launches}",
          flush=True)
    print(f"pt slice: {statistics.median(times):.4f} s/case median of "
          f"{[round(t, 4) for t in times]} on {card}", flush=True)
    return launches, times


def phase_pt_train(ks, knn_cuda, card: str):
    """The PointTransformer training slice through the entry point, then 10
    timed warm steps. Counts are reset before and read after."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (PointTransformerSeg,
                                                       export_jax_variables,
                                                       load_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, canonical_data, make_step, time_steps)
    with tempfile.TemporaryDirectory() as tmp:
        _reset(ks, knn_cuda)
        t0 = time.perf_counter()
        if train_point_seg.main(PT_TRAIN_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("pt train: the entry point failed")
        entry = _counts(ks, knn_cuda)
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        if len(hist) != 3 or not np.isfinite(hist).all():
            raise AssertionError(f"pt train: loss history {hist}")
        model = load_model(os.path.join(fold, "model.pt"),
                           PointTransformerSeg)
        stats = export_jax_variables(model)["batch_stats"]
        still = [name for name, leaf in _leaves(stats)
                 if np.array_equal(leaf, np.zeros_like(leaf))
                 or np.array_equal(leaf, np.ones_like(leaf))]
        if still:
            raise AssertionError(f"pt train: running statistics never "
                                 f"moved: {still}")
        print(f"pt train: entry point (3 epochs, fold 0) in "
              f"{time.perf_counter() - t0:.1f} s; loss history {hist}; "
              f"launches {entry}", flush=True)

        ds, loss_fn = canonical_data()
        step = make_step(ds, loss_fn, tmp, model="PointTransformer")
        for _ in range(WARM):
            step()
        before = _counts(ks, knn_cuda)
        ms, peak, losses = time_steps(step)
        after = _counts(ks, knn_cuda)
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError("pt train: non-finite loss")
    launched = {k: after[k] - before[k] for k in after}
    if launched["fps"] < 4 * STEPS:
        raise AssertionError(f"pt train: K5 launched {launched['fps']} times "
                             f"in {STEPS} steps; each step needs >= 4")
    timing = {"ms_per_step": ms, "clouds_per_s": 32e3 / ms,
              "peak_bytes": peak, "launches_10_steps": launched}
    print(f"pt train: step {ms:.2f} ms ({32e3 / ms:.1f} clouds/s), peak "
          f"{peak / 2 ** 30:.2f} GiB, launches in {STEPS} steps {launched} "
          f"on {card}", flush=True)
    return _counts(ks, knn_cuda), timing


class SelectionRecorder:
    """Records every FPS and kNN selection of PointTransformerSeg's forward
    (the module-level names its code calls are wrapped while active)."""

    def __init__(self):
        self.fps, self.knn = [], []

    def __enter__(self):
        from fissure_segmentation_tpu_torch.models import \
            point_transformer as pt
        from fissure_segmentation_tpu_torch.ops import pointops as po
        self._mods = (pt, po)
        self._saved = (pt.farthest_point_sampling, pt.knn_query,
                       po.knn_query)
        fps0, knn0 = pt.farthest_point_sampling, po.knn_query

        def fps(*args, **kwargs):
            out = fps0(*args, **kwargs)
            self.fps.append(out.detach().cpu())
            return out

        def knn(*args, **kwargs):
            idx, dist = knn0(*args, **kwargs)
            self.knn.append(idx.detach().cpu())
            return idx, dist
        pt.farthest_point_sampling, pt.knn_query, po.knn_query = fps, knn, knn
        return self

    def __exit__(self, *exc):
        pt, po = self._mods
        pt.farthest_point_sampling, pt.knn_query, po.knn_query = self._saved


def _pt_reference_model(seed):
    """Full-width PointTransformerSeg with nonzero BatchNorm offsets (see
    _reference_model)."""
    from fissure_segmentation_tpu_torch.models import PointTransformerSeg
    return _draw_bn_offsets(PointTransformerSeg(
        in_features=4, num_classes=4,
        generator=torch.Generator().manual_seed(seed)), seed)


def phase_pt_reference():
    """PointTransformerSeg at full depth and width, B=8 x N=1024 points
    with dyadic coordinates (multiples of 1/16: every distance exact, so
    both sides select the same neighbours unless a kernel is wrong): one
    step as ModelTrainer.train_step takes it (NNU loss, Adam with L2) on the
    card (K5) and on the CPU (plain versions) from the same weights and
    batch, recording every FPS and kNN selection.

    FPS selections must be equal. An input whose kNN selections differ is
    set aside (up to REF_SEEDS). The tolerances follow how well float32
    itself computes this step, measured on the CPU against the same model
    in float64 (BatchNorm statistics and softmax in float64;
    scripts/prof/pt_float32_conditioning.py): train-mode
    BatchNorm normalises by the batch's own statistics, and over the coarse
    stages' few samples it amplifies rounding. At B=2 x 512 (stage 4: 2 x 2
    points) float32 missed float64 by 0.7 % in the loss, 1.1 in a logit and
    41 % in the gradient (relative L2): no two float32 runs agree there. At
    B=8 x 1024: loss 6e-6 relative, logits 1.8e-3, running statistics
    3.9e-5, gradient 2.2 % (relative L2), eval-mode gradients 1.1e-4. So,
    on the first agreeing input:
      * loss and components within rtol 5e-5, running statistics within
        2e-4;
      * the train-mode gradient as a whole within 0.1 in relative L2, not
        leaf by leaf;
      * every updated parameter within 2e-4 of the CPU's Adam on the
        card's gradients, and card vs CPU where Adam's input g' = g + wd p
        has one sign and |g'| >= ADAM_PINNED on both sides (the rest
        counted, at most PT_UNPINNED_SHARE);
      * in eval mode (running statistics: no such amplification) the
        logits within 2e-4 and every gradient leaf of sum(logits * w) within
        rtol = atol = 5e-4: that gradient sums 8 x 1024 x 4 terms, float32
        alone misses float64 by up to 1.1e-4 there, and the card's float32
        (its gather backward adds with atomics, in no fixed order) was
        seen 1.98e-4 and 2.29e-4 from the CPU's on an H100."""
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    cfg = TrainConfig()
    cw = torch.tensor([0.4, 1.2, 1.1, 1.3])
    set_aside = []
    for seed in range(REF_SEEDS):
        rng = np.random.default_rng(200 + seed)
        x = torch.from_numpy((rng.integers(-16, 17, (8, 1024, 4)) / 16.0)
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 4, (8, 1024)))
        w = torch.from_numpy(rng.normal(size=(8, 1024, 4)).astype(
            np.float32))
        model0 = _pt_reference_model(seed)
        side = {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model0).to(dev)
            opt = torch.optim.Adam(m.parameters(), lr=cfg.lr,
                                   weight_decay=cfg.weight_decay)
            loss_fn = get_loss_fn("nnunet", cw.to(dev))
            m.train()
            with SelectionRecorder() as rec:
                loss, comps = loss_fn(m(x.to(dev)), y.to(dev))
            loss.backward()
            grads = dict(_leaves(export_jax_variables(m, grad=True)))
            opt.step()
            side[dev] = (m, float(loss.detach()), {k: float(v) for k, v in
                                          comps.items()}, rec, grads)
        (m_g, l_g, c_g, r_g, g_g), (m_c, l_c, c_c, r_c, g_c) = \
            side["cuda"], side["cpu"]
        if len(r_g.fps) != len(r_c.fps) or not all(
                torch.equal(a, b) for a, b in zip(r_g.fps, r_c.fps)):
            raise AssertionError("pt reference: FPS selections differ card "
                                 "vs CPU")
        knn_diff = sum(int((a != b).sum()) for a, b in zip(r_g.knn, r_c.knn))
        if knn_diff:
            set_aside.append((seed, knn_diff))
            continue
        _close("pt loss", l_g, l_c, rtol=5e-5, atol=0)
        for k in c_c:
            _close(f"pt {k}", c_g[k], c_c[k], rtol=5e-5, atol=0)
        v_g = dict(_leaves(export_jax_variables(m_g)))
        v_c = dict(_leaves(export_jax_variables(m_c)))
        for name in v_c:
            if name.startswith("batch_stats/"):
                _close(f"pt {name}", v_g[name], v_c[name], **TRAIN_TOL)
        gap = np.sqrt(sum(np.sum((g_g[k] - g_c[k]) ** 2) for k in g_c))
        norm = np.sqrt(sum(np.sum(g_c[k] ** 2) for k in g_c))
        if gap > 0.1 * norm:
            raise AssertionError(f"pt reference: train-mode gradient "
                                 f"{gap / norm:.3g} apart in relative L2")
        adam = copy.deepcopy(model0)
        for p, q in zip(adam.parameters(), m_g.parameters()):
            p.grad = q.grad.detach().cpu()
        torch.optim.Adam(adam.parameters(), lr=cfg.lr,
                         weight_decay=cfg.weight_decay).step()
        want = dict(_leaves(export_jax_variables(adam)))
        start = dict(_leaves(export_jax_variables(model0)))
        n_params, unpinned, upd_gap = 0, 0, 0.0
        for name in g_c:
            _close(f"pt updated {name}", v_g[name], want[name], **TRAIN_TOL)
            wd_p = cfg.weight_decay * start[name]
            a, b = g_g[name] + wd_p, g_c[name] + wd_p
            free = (np.sign(a) != np.sign(b)) | \
                (np.minimum(np.abs(a), np.abs(b)) < ADAM_PINNED)
            _close(f"pt updated {name}", v_g[name][~free], v_c[name][~free],
                   **TRAIN_TOL)
            if (~free).any():
                upd_gap = max(upd_gap, float(np.abs(
                    v_g[name][~free] - v_c[name][~free]).max()))
            n_params += free.size
            unpinned += int(free.sum())
        if unpinned > PT_UNPINNED_SHARE * n_params:
            raise AssertionError(f"pt reference: {unpinned} of {n_params} "
                                 "Adam steps not pinned")
        eval_grads, logits = {}, {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model0).to(dev).eval()
            out = m(x.to(dev))
            (out * w.to(dev)).sum().backward()
            logits[dev] = out.detach().cpu().numpy()
            eval_grads[dev] = dict(_leaves(export_jax_variables(m,
                                                                grad=True)))
        _close("pt eval logits", logits["cuda"], logits["cpu"], **TRAIN_TOL)
        e_gap = 0.0
        for name in eval_grads["cpu"]:
            _close(f"pt eval grad {name}", eval_grads["cuda"][name],
                   eval_grads["cpu"][name], **PT_EVAL_GRAD_TOL)
            e_gap = max(e_gap, float(np.abs(eval_grads["cuda"][name]
                                            - eval_grads["cpu"][name]).max()))
        print(f"pt reference: seed {seed} (set aside, (seed, differing kNN "
              f"selections): {set_aside}); {len(r_c.fps)} FPS and "
              f"{len(r_c.knn)} kNN selections equal card vs CPU; loss "
              f"{l_g:.7f} vs {l_c:.7f}; running statistics within 2e-4; "
              f"train-mode gradient {gap / norm:.3g} apart (relative L2); "
              f"updated parameters within 2e-4 of the CPU's Adam on the "
              f"card's gradients, and card vs CPU (max |diff| {upd_gap:.3g}) "
              f"but {unpinned} of {n_params} unpinned; eval-mode logits "
              f"within 2e-4, gradient leaves within 5e-4 (max |diff| "
              f"{e_gap:.3g})", flush=True)
        return
    raise AssertionError(f"pt reference: no input of {REF_SEEDS} with equal "
                         f"kNN selections: {set_aside}")


# ---- the CNN keypoint path (K6) ---------------------------------------------

def _dw_library(x, w, stride=1):
    """cuDNN's grouped conv3d on the channels_last_3d view of NDHWC x: the
    library yardstick for K6 (timed here, never called by the port)."""
    c = x.shape[-1]
    return torch.nn.functional.conv3d(
        x.permute(0, 4, 1, 2, 3), w.permute(3, 0, 1, 2).unsqueeze(1),
        stride=stride, padding=1, groups=c)


# K6's stride-2 mode: name: (shape, dtype, launches per CNN forward, timed)
DW_STRIDE2 = {
    # block 5 of MobileNetASPP on a 256^3 CT (serving), and in bf16
    "s2_b5_1x128x128x128x192": ((1, 128, 128, 128, 192), "float32", 1, True),
    "s2_bf16_1x128x128x128x192": ((1, 128, 128, 128, 192), "bfloat16", 0,
                                  True),
    # the train step's: v1 block 5, v3 rows 1 and 6 (32 patches of 96^3)
    "s2_v1_b5_32x48x48x48x192": ((32, 48, 48, 48, 192), "float32", 0, True),
    "s2_v3_r1_32x48x48x48x64": ((32, 48, 48, 48, 64), "float32", 0, True),
    "s2_v3_r6_32x12x12x12x240": ((32, 12, 12, 12, 240), "float32", 0, True),
    # hard cases: odd D, H, W (ceil(n / 2) outputs), D = 1 and 2, H and W
    # off the 4 x 8 output tile, C off the 16-byte rows (the simple
    # kernel), bf16 off the 8-channel copies
    "s2_odd_1x9x13x21x32": ((1, 9, 13, 21, 32), "float32", 0, False),
    "s2_odd_2x7x9x11x96": ((2, 7, 9, 11, 96), "float32", 0, False),
    "s2_d1_1x1x12x20x64": ((1, 1, 12, 20, 64), "float32", 0, False),
    "s2_d2_1x2x8x16x144": ((1, 2, 8, 16, 144), "float32", 0, False),
    "s2_tile_edges_1x6x11x19x192": ((1, 6, 11, 19, 192), "float32", 0,
                                    False),
    "s2_c33_1x6x7x9x33": ((1, 6, 7, 9, 33), "float32", 0, False),
    "s2_c5_2x5x4x3x5": ((2, 5, 4, 3, 5), "float32", 0, False),
    "s2_bf16_1x5x9x9x40": ((1, 5, 9, 9, 40), "bfloat16", 0, False),
    "s2_bf16_1x3x5x6x12": ((1, 3, 5, 6, 12), "bfloat16", 0, False),
}


def phase_depthwise(dw_cuda, dw_plain):
    """K6 against its plain version at the CNN path's shapes (the seven
    stride-1 depthwise layers of MobileNetASPP on a 256^3 CT; (128^3, 144)
    occurs twice), bfloat16 at the widest, a ragged shape and D = 1:
    outputs equal; median times of the kernel, the plain version and the
    library call, and the bound. Then K6's stride-2 mode (DW_STRIDE2: block
    5's serving shape in f32 and bf16, the train step's three stride-2
    layers, the hard cases): outputs equal to the plain version; at the
    path shapes median times of the kernel, the plain version and cuDNN's
    grouped stride-2 conv3d (the library call), with the bound. Returns
    (max |kernel - plain|, {shape: timings}, the sums over one forward's
    seven stride-1 launches, {stride-2 shape: timings})."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {
        # name: (shape, dtype, launches per CNN forward, timed)
        "b0_1x128x128x128x32": ((1, 128, 128, 128, 32), f32, 1, True),
        "b1_1x128x128x128x96": ((1, 128, 128, 128, 96), f32, 1, True),
        "b2b3_1x128x128x128x144": ((1, 128, 128, 128, 144), f32, 2, True),
        "b4_1x128x128x128x192": ((1, 128, 128, 128, 192), f32, 1, True),
        "b6_1x64x64x64x192": ((1, 64, 64, 64, 192), f32, 1, True),
        "b7_1x64x64x64x384": ((1, 64, 64, 64, 384), f32, 1, True),
        "bf16_1x128x128x128x192": ((1, 128, 128, 128, 192), bf16, 0, True),
        "ragged_2x7x9x11x5": ((2, 7, 9, 11, 5), f32, 0, False),
        "d1_1x1x6x10x5": ((1, 1, 6, 10, 5), f32, 0, False),
        # the tiled kernel's hard cases: H and W off the tile, a channel
        # slice cut short, C off the 16-byte copies, D = 1 and 2, B = 2
        "tile_edges_1x9x13x21x32": ((1, 9, 13, 21, 32), f32, 0, False),
        "c33_1x6x7x9x33": ((1, 6, 7, 9, 33), f32, 0, False),
        "c36_1x5x11x18x36": ((1, 5, 11, 18, 36), f32, 0, False),
        "c96_1x5x10x19x96": ((1, 5, 10, 19, 96), f32, 0, False),
        "c144_2x3x17x9x144": ((2, 3, 17, 9, 144), f32, 0, False),
        "c384_1x4x9x18x384": ((1, 4, 9, 18, 384), f32, 0, False),
        "d1_1x1x12x20x96": ((1, 1, 12, 20, 96), f32, 0, False),
        "d2_1x2x8x16x144": ((1, 2, 8, 16, 144), f32, 0, False),
        "bf16_2x3x10x11x64": ((2, 3, 10, 11, 64), bf16, 0, False),
        "bf16_1x4x9x9x144": ((1, 4, 9, 9, 144), bf16, 0, False),
        "bf16_1x3x7x10x40": ((1, 3, 7, 10, 40), bf16, 0, False),
        "bf16_1x2x5x6x12": ((1, 2, 5, 6, 12), bf16, 0, False),
        "bf16_d1_1x1x9x17x192": ((1, 1, 9, 17, 192), bf16, 0, False),
    }
    cases = {k: (*v, 1) for k, v in cases.items()}
    cases.update({k: (shape, getattr(torch, dt), per_fwd, timed, 2)
                  for k, (shape, dt, per_fwd, timed) in DW_STRIDE2.items()})
    max_err, timings, stride2 = 0.0, {}, {}
    forward = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "launches": 0}
    for name, (shape, dtype, per_fwd, timed, s) in cases.items():
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        w = torch.randn((3, 3, 3, shape[-1]), generator=g, device=dev).to(dtype)
        got = dw_cuda(x, w, s)
        torch.cuda.synchronize()
        want = dw_plain(x, w, s)
        torch.cuda.synchronize()
        max_err = max(max_err,
                      (got.float() - want.float()).abs().max().item())
        if not torch.equal(got, want):
            raise AssertionError(
                f"K6 {name}: kernel differs from plain "
                f"({(got != want).sum().item()} outputs, max "
                f"{(got.float() - want.float()).abs().max().item():.3g})")
        line = f"K6 {name}: kernel == plain (outputs)"
        if timed:
            t_k = median_ms(lambda: dw_cuda(x, w, s))
            t_p = median_ms(lambda: dw_plain(x, w, s), reps=3, inner=1,
                            warm=1)
            t_l = median_ms(lambda: _dw_library(x, w, s), reps=3, inner=1,
                            warm=1)
            lib_err = (_dw_library(x, w, s).permute(0, 2, 3, 4, 1).float()
                       - got.float()).abs().max().item()
            # read x and w once, write y; 27 multiplies and 27 adds an output
            bound, by = bound_ms((x.numel() + got.numel() + w.numel())
                                 * x.element_size(), 54 * got.numel())
            t = {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
                 "bound_by": by, "library_ms": t_l,
                 "library_max_abs_diff": lib_err}
            if s == 2:
                stride2[name] = {**t, "launches_per_forward": per_fwd}
            else:
                timings[name] = t
                for key, val in (("ms", t_k), ("plain_ms", t_p),
                                 ("bound_ms", bound), ("library_ms", t_l)):
                    forward[key] += per_fwd * val
                forward["launches"] += per_fwd
            line += (f"; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
                     f"conv3d {t_l:.4f} ms (median; library differs by "
                     f"{lib_err:.3g}), bound {bound:.4f} ms ({by})")
        print(line, flush=True)
        del x, w, got, want
        torch.cuda.empty_cache()
    print(f"K6 one CNN forward ({forward['launches']} stride-1 launches): "
          f"kernel {forward['ms']:.4f} ms, plain {forward['plain_ms']:.4f} "
          f"ms, library {forward['library_ms']:.4f} ms, bound "
          f"{forward['bound_ms']:.4f} ms; and block 5's stride-2 launch "
          f"{stride2['s2_b5_1x128x128x128x192']['ms']:.4f} ms", flush=True)
    return max_err, timings, forward, stride2


def _cnn_model(seed):
    """MobileNetASPP(num_classes=4) at full width from seeded weights, with
    every BatchNorm offset drawn nonzero (eval-mode BatchNorm is then no
    identity)."""
    from fissure_segmentation_tpu_torch.models import MobileNetASPP
    return _draw_bn_offsets(MobileNetASPP(
        num_classes=4, generator=torch.Generator().manual_seed(seed)), seed)


def _cnn_flops(cnn, vol) -> dict:
    """Multiply-add operations (2 per product) of one whole-volume forward
    of `cnn` on `vol`, by kind of convolution, counted from every conv's
    output shape with forward hooks (one extra forward)."""
    from fissure_segmentation_tpu_torch.models import predict_full_volume
    from fissure_segmentation_tpu_torch.models.seg_cnn import (Conv,
                                                               DepthwiseConv3)
    flops = {"dense_3x3x3": 0, "1x1x1": 0, "depthwise_k6": 0,
             "depthwise_stride2": 0}

    def hook(mod, _, out):
        if isinstance(mod, DepthwiseConv3):
            flops["depthwise_k6"] += 2 * 27 * out.numel()
            return
        taps = mod.weight[0].numel()              # in / groups * kd kh kw
        kind = ("1x1x1" if mod.kernel_size == (1, 1, 1) else
                "depthwise_stride2" if mod.groups > 1 else "dense_3x3x3")
        flops[kind] += 2 * taps * out.numel()
    handles = [m.register_forward_hook(hook) for m in cnn.modules()
               if isinstance(m, (Conv, DepthwiseConv3))]
    try:
        predict_full_volume(cnn, vol)
    finally:
        for h in handles:
            h.remove()
    return flops


def phase_cnn_slice(dw_cuda, card: str):
    """The serving slice in kp_mode="cnn" at full size: the CNN's
    whole-volume forward on the 256^3 CT inside segment_case, then the
    keypoints, the DGCNNSeg(k=40) ensemble with phase 4's class bias and
    the surface fit; one warm-up and 3 timed cases with phase 4's checks.
    K6 must launch at least 7 times a case at stride 1 and once at
    stride 2 (block 5). Then the CNN forward alone
    (CUDA events) and one kp_mode="enhancement" case. Returns (K6
    launches of the timed cases, timings)."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       predict_full_volume)
    from fissure_segmentation_tpu_torch.serving import segment_case
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = DGCNNSeg(k=40, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    apply = biased_model(model, case, SHAPE)
    cnn = _cnn_model(0).cuda()

    def run(seed):
        return segment_case(vol, mask, apply,
                            torch.Generator().manual_seed(seed),
                            kp_mode="cnn", cnn_model=cnn,
                            center_x=SHAPE[2] / 2)

    t0 = time.perf_counter()
    check_result(run(1), SHAPE, "cnn warm-up case")
    print(f"cnn slice: warm-up case {time.perf_counter() - t0:.3f} s",
          flush=True)
    n_cases = 3
    for fn in (dw_cuda, knn_cuda, gather_reduce):
        _zero(fn)
    gather_reduce.calls.clear()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_cases):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"cnn case {i}")
    peak = torch.cuda.max_memory_allocated()
    launches = {"depthwise_conv3": dw_cuda.roles["forward"],
                "depthwise_conv3_stride2": dw_cuda.roles["stride2"],
                "knn": knn_cuda.launches,
                "gather_reduce": gather_reduce.launches}
    # the timed cases' gather-reduce calls (the enhancement case below is
    # not counted, like its launches)
    phase_cnn_slice.gr_calls = dict(gather_reduce.calls)
    if launches["depthwise_conv3"] < 7 * n_cases or \
            launches["depthwise_conv3_stride2"] < n_cases:
        raise AssertionError(f"K6 launched {launches} in {n_cases} cnn "
                             f"cases; the path needs >= {7 * n_cases} at "
                             f"stride 1 and >= {n_cases} at stride 2")
    tri = [int(v.sum()) for _, v in res.meshes]
    print(f"cnn slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {tri}; launches in {n_cases} timed cases {launches}",
          flush=True)
    fwd_ms = median_ms(lambda: predict_full_volume(cnn, vol), reps=3,
                       inner=1, warm=1)
    flops = _cnn_flops(cnn, vol)
    total = sum(flops.values())
    timing = {"s_per_case": statistics.median(times),
              "cases_s": times, "cnn_forward_ms": fwd_ms,
              "cnn_forward_flops": flops, "peak_bytes": peak}
    print(f"cnn slice: {timing['s_per_case']:.4f} s/case median of "
          f"{[round(t, 4) for t in times]}; CNN forward {fwd_ms:.3f} ms "
          f"(CUDA events, median of 3); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB on {card}", flush=True)
    print(f"cnn slice: the CNN forward's convolutions do {total / 1e12:.4f} "
          f"TFLOP ({', '.join(f'{k} {v / 1e9:.1f}' for k, v in flops.items())}"
          f" GFLOP): at least {total / F32_FLOPS * 1e3:.2f} ms at the f32 "
          f"peak; {total / fwd_ms / 1e9:.2f} TFLOP/s achieved", flush=True)

    # the enhancement mode: the synthetic CT is not in Hounsfield units
    # (parenchyma -0.6, fissures -0.25, noise 0.05), so the intensity
    # weighting is centred on its fissures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = segment_case(vol, mask, apply, torch.Generator().manual_seed(9),
                       kp_mode="enhancement", fissure_mu=-0.25,
                       fissure_sigma=0.1, center_x=SHAPE[2] / 2)
    timing["enhancement_case_s"] = time.perf_counter() - t0
    check_result(res, SHAPE, "enhancement case")
    print(f"enhancement slice: {len(res.kpts)} valid keypoints, labels "
          f"{np.bincount(res.labels, minlength=4).tolist()}, valid triangles "
          f"per class {[int(v.sum()) for _, v in res.meshes]}; one case "
          f"{timing['enhancement_case_s']:.4f} s (first in this mode) on "
          f"{card}", flush=True)
    return launches, timing


def phase_cnn_reference():
    """The CNN on a small input at full width, card (K6) against CPU (plain
    versions), TF32 off: softmax volumes within CNN_SOFT_TOL (both sides
    sum each convolution in float32 in another order: about 1e-6 relative
    a layer over some twenty layers; 5e-5 on probabilities leaves a margin
    of ten); argmax equal except where the CPU's top-two margin is below
    twice that; the staged keypoints with the same injected scores equal,
    but for the voxels whose argmax flipped (each moves at most two
    keypoints)."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.keypoints.extraction import \
        get_cnn_keypoints
    from fissure_segmentation_tpu_torch.models import predict_full_volume
    shape = (40, 48, 56)
    case = make_synthetic_image_case(2, shape=shape)
    cnn = _cnn_model(6)   # its argmax splits the lung into bg and fg
    img = torch.from_numpy(case["image"])
    mask = torch.from_numpy(case["lung_mask"])
    soft = {"cpu": predict_full_volume(cnn, img)}
    soft["cuda"] = predict_full_volume(copy.deepcopy(cnn).cuda(),
                                       img.cuda()).cpu()
    err = (soft["cuda"] - soft["cpu"]).abs().max().item()
    if not err <= CNN_SOFT_TOL:
        raise AssertionError(f"cnn reference: softmax differs by {err:.3g} "
                             f"> {CNN_SOFT_TOL}")
    top2 = soft["cpu"].topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flipped = soft["cuda"].argmax(-1) != soft["cpu"].argmax(-1)
    if (flipped & (margin >= 2 * CNN_SOFT_TOL)).any():
        raise AssertionError("cnn reference: argmax differs at a voxel with "
                             "a clear margin")
    scores = torch.rand(img.numel(), generator=torch.Generator().manual_seed(3))
    kp = {}
    for dev in ("cuda", "cpu"):
        k, v, _ = get_cnn_keypoints(soft[dev].to(dev), mask.to(dev),
                                    max_kpts=2000, scores=scores.to(dev))
        kp[dev] = {tuple(r) for r in k[v].cpu().tolist()}
    n_flip = int(flipped.sum())
    diff = len(kp["cuda"] ^ kp["cpu"])
    if diff > 2 * n_flip or (n_flip == 0 and diff):
        raise AssertionError(f"cnn reference: keypoints differ in {diff} "
                             f"with {n_flip} flipped voxels")
    classes = np.bincount(soft["cpu"].argmax(-1)[mask].numpy(), minlength=4)
    print(f"cnn reference: {shape} card vs CPU: softmax max abs diff "
          f"{err:.3g} (tol {CNN_SOFT_TOL}), argmax flips {n_flip} (all at "
          f"margins < {2 * CNN_SOFT_TOL}), keypoints {len(kp['cpu'])} with "
          f"{diff} differing; argmax per class in the lung "
          f"{classes.tolist()}", flush=True)
    return err


# ---- the fused gather-reduce, the bf16 step and the probes ------------------

def _old_gather_reduce(a, idx, want):
    """What the port ran before the gather-reduce kernel: the flat gather of
    the whole (B, N, K, C) neighbour tensor, then one reduction per output
    (timed as the 'old' column only)."""
    from fissure_segmentation_tpu_torch.ops.edge import _flat_gather
    ga = _flat_gather(a, idx)
    if want == "max":
        return (ga.amax(dim=2),)
    if want == "extrema":
        return ga.amax(dim=2), ga.amin(dim=2)
    gaf = ga.to(torch.float32)
    return (ga.amax(dim=2), ga.amin(dim=2), ga.argmax(dim=2),
            ga.argmin(dim=2), gaf.sum(dim=2), (gaf * gaf).sum(dim=2))


def _gr_bytes(a, idx, want) -> int:
    """Bytes the gather-reduce must move: a and idx read once, the outputs
    written once."""
    b, n, c = a.shape
    out = {"max": a.element_size(), "extrema": 2 * a.element_size(),
           "all": 2 * a.element_size() + 4 * 4}[want]
    return (a.numel() * a.element_size() + idx.numel() * 4
            + b * n * c * out)


def phase_gather_reduce(knn_cuda):
    """The gather-reduce against its plain version: every output equal
    (torch.equal), for every want and dtype, at the path's shapes (the train
    step's on K1's graph; the serving ensemble's, whose 5 clouds x 4 slices
    take the cluster route: clusters of blocks that share each staged
    slice), a lattice full of k-ties, indices out of range (rows in other
    clouds), C off the staged slice (33, 36, 40, 200, 256), more than 32
    slots, points split among blocks, and N where the slice just fits in
    shared memory and just does not (the kernel that reads device memory);
    then the few-cloud set at 5 and 1 clouds (k-ties, NaNs, signed zeros,
    one NaN and one -0.0 row in the rows of one block of a cluster alone,
    out-of-range indices, C = 33, 36, 200, 256, K = 70, N = 3200), each
    output equal to plain in every bit, NaNs aside (`_gr_same`), each
    case's route printed. Timings at the path's shapes: back to back
    through the wrapper (`median_ms`) and on the card alone (`graph_ms`,
    "card_ms"), beside the bound and an empty launch's time on the card.
    Returns (max |kernel - plain| over every output and case, NaNs aside,
    {call: timings}), keyed by `gather_reduce.call_key`."""
    import torch.nn.functional as F
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import (
        STAGED_MAX_N, call_key, flat_rows, gather_reduce,
        gather_reduce_plain, route)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    empty_ms = graph_ms(lambda: torch.cuda._sleep(0))
    print(f"gather_reduce: an empty launch on the card alone {empty_ms:.4f} "
          f"ms (graph_ms)", flush=True)
    graphs = {}
    for b in (32, 5):
        pts = torch.rand((b, 2048, 3), generator=g, device=dev) * 2 - 1
        graphs[b] = knn_cuda(pts, 40)[0].contiguous()

    def draw(b, n, k):
        return torch.randint(0, n, (b, n, k), generator=g, device=dev,
                             dtype=torch.int32)
    bad = draw(3, 300, 24)
    bad[:, ::7, 0] = -1                   # wraps to the last row
    bad[:, 3::11, 5] = 300 + 17           # clamps
    bad[1, :, 9] = -5000                  # clamps to row 0
    cases = {
        # name: (idx, table maker, C, timed)
        "train": (graphs[32], "normal", 64, True),
        "serve": (graphs[5], "normal", 64, True),
        "lattice_ties": (draw(4, 512, 40), "lattice", 64, False),
        "out_of_range": (bad, "normal", 40, False),
        "c33": (draw(17, 500, 40), "normal", 33, False),
        "c36": (draw(17, 500, 40), "normal", 36, False),
        "c200": (draw(12, 500, 40), "normal", 200, False),
        "c256": (draw(3, 500, 40), "normal", 256, False),
        "k70_c8": (draw(2, 64, 70), "normal", 8, False),
        "split_points": (draw(11, 2048, 40), "normal", 64, False),
        "slice_fits": (draw(16, STAGED_MAX_N, 24), "normal", 64, False),
        "slice_spills": (draw(16, STAGED_MAX_N + 1, 24), "normal", 64,
                         False),
    }
    timings, max_err = {}, 0.0
    for name, (idx, kind, c, timed) in cases.items():
        b, n, k = idx.shape
        if kind == "lattice":
            base = torch.randint(0, 3, (b, n, c), generator=g,
                                 device=dev).float()
        else:
            base = torch.randn((b, n, c), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            a = base.to(dtype)
            for want in ("max", "extrema", "all"):
                got = gather_reduce(a, idx, want)
                torch.cuda.synchronize()
                ref = gather_reduce_plain(a, idx, want)
                max_err = max([max_err] + [_gr_err(x, y)
                                           for x, y in zip(got, ref)])
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise AssertionError(
                        f"gather_reduce {name} {b}x{n}x{k}x{c} {dtype} "
                        f"{want}: kernel differs from plain in "
                        f"{[int((x != y).sum()) for x, y in zip(got, ref)]}")
                if not timed:
                    continue
                key = call_key(a, idx, want)
                t_k = median_ms(lambda: gather_reduce(a, idx, want))
                t_c = graph_ms(lambda: gather_reduce(a, idx, want))
                t_p = median_ms(lambda: gather_reduce_plain(a, idx, want),
                                reps=3, inner=1, warm=1)
                t_o = median_ms(lambda: _old_gather_reduce(a, idx, want),
                                reps=3, inner=3, warm=1)
                t_l = None
                if want == "max":
                    table = a.view(b * n, c)
                    bags = flat_rows(idx, n).view(b * n, -1)
                    t_l = median_ms(lambda: F.embedding_bag(
                        bags, table, mode="max"), reps=3, inner=3, warm=1)
                # per (point, slot, channel): two compares, and for "all"
                # a multiply and two adds
                ops = idx.numel() * c * (5 if want == "all" else
                                         2 if want == "extrema" else 1)
                bound, by = bound_ms(_gr_bytes(a, idx, want), ops)
                timings[key] = {"ms": t_k, "card_ms": t_c, "plain_ms": t_p,
                                "old_ms": t_o, "library_ms": t_l,
                                "bound_ms": bound, "bound_by": by,
                                "empty_launch_ms": empty_ms,
                                "route": route(b, n, k, c, dtype,
                                               want).kind}
                print(f"gather_reduce {key}: kernel == plain (every "
                      f"output); kernel {t_k:.4f} ms ({t_c:.4f} on the "
                      f"card alone), plain {t_p:.4f} ms, "
                      f"old gather + reductions {t_o:.4f} ms, library "
                      f"{'none' if t_l is None else f'{t_l:.4f} ms'} "
                      f"(median), bound {bound:.4f} ms ({by})", flush=True)
        print(f"gather_reduce {name} {b}x{n}x{k}x{c}: kernel == plain "
              f"(every output, every want, f32 and bf16); routes f32 / bf16 "
              f"{_gr_routes(route, b, n, k, c)}", flush=True)
    # the few-cloud set: 5 and 1 clouds, the cluster route's hard cases
    for b in (5, 1):
        for name in GR_FEW_CLOUD:
            base, idx = _gr_few_cloud(name, b, g)
            n, c = base.shape[1], base.shape[2]
            for dtype in (torch.float32, torch.bfloat16):
                a = base.to(dtype)
                for want in ("max", "extrema", "all"):
                    got = gather_reduce(a, idx, want)
                    torch.cuda.synchronize()
                    ref = gather_reduce_plain(a, idx, want)
                    max_err = max([max_err] + [_gr_err(x, y)
                                               for x, y in zip(got, ref)])
                    if not all(_gr_same(x, y) for x, y in zip(got, ref)):
                        raise AssertionError(
                            f"gather_reduce few clouds {name} "
                            f"{tuple(idx.shape)}x{c} {dtype} {want}: kernel "
                            f"differs from plain on "
                            f"{route(b, n, idx.shape[-1], c, dtype, want)}")
            print(f"gather_reduce few clouds {name} {tuple(idx.shape)}x{c}: "
                  f"kernel == plain in every bit, NaNs aside (every want, "
                  f"f32 and bf16); routes f32 / bf16 "
                  f"{_gr_routes(route, b, n, idx.shape[-1], c)}",
                  flush=True)
    return max_err, timings


# the few-cloud cases of phase 16 (`_gr_few_cloud`)
GR_FEW_CLOUD = ("lattice_ties", "nans", "signed_zeros", "nan_one_rank",
                "zero_one_rank", "out_of_range", "c33", "c36", "c200",
                "c256", "k70", "n3200")


def _gr_few_cloud(name: str, b: int, g) -> tuple:
    """(a float32, idx) of a few-cloud case on the card: N = 2048, K = 40,
    C = 64 unless the case names another; k-ties, NaNs (1 % and a whole
    row), zeros of both signs tied among themselves, or out-of-range
    indices where the case says. "nan_one_rank" and "zero_one_rank" keep
    the table clean but for one NaN, or one row of -0.0 tied with a row of
    +0.0, in the last rows of cloud 0 (which only the last block of a
    cluster copies and scans), read by points all over the cloud."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        STAGED_MAX_N
    n, k, c = 2048, 40, 64
    if name[0] == "c":
        c = int(name[1:])
    elif name == "k70":
        k = 70
    elif name == "n3200":
        n = STAGED_MAX_N
    dev = torch.device("cuda")
    if name == "lattice_ties":
        a = torch.randint(0, 3, (b, n, c), generator=g, device=dev).float()
    elif name == "signed_zeros":
        a = torch.randint(-1, 2, (b, n, c), generator=g,
                          device=dev).float() * 0.0
        a[:, ::3] = torch.randint(-2, 3, (b, (n + 2) // 3, c), generator=g,
                                  device=dev).float()
    else:
        a = torch.randn((b, n, c), generator=g, device=dev)
    if name == "zero_one_rank":   # the zeros: channel 0's max, 1's min
        a[..., 0] = -(a[..., 0].abs() + 0.1)
        a[..., 1] = a[..., 1].abs() + 0.1
        a[0, n - 1, :2] = -0.0
        a[0, n - 2, :2] = 0.0
    if name == "nan_one_rank":
        a[0, n - 1, 0] = float("nan")
    if name == "nans":
        a[torch.rand((b, n, c), generator=g, device=dev) < 0.01] = \
            float("nan")
        a[0, 7] = float("nan")
    idx = torch.randint(0, n, (b, n, k), generator=g, device=dev,
                        dtype=torch.int32)
    if name == "out_of_range":
        idx[:, ::7, 0] = -1
        idx[:, 3::11, 5] = n + 17
        idx[-1, :, 9] = -5000 * n
    if name == "nan_one_rank":
        idx[0, ::3, 3] = n - 1
    if name == "zero_one_rank":   # either zero seen first
        idx[0, ::3, 2], idx[0, ::3, 5] = n - 1, n - 2
        idx[0, 1::3, 2], idx[0, 1::3, 5] = n - 2, n - 1
    return a, idx


def _gr_same(x, y) -> bool:
    """Equal in every bit, -0.0 and +0.0 told apart; a NaN matches a NaN
    (torch.equal holds no NaN equal, and the card's float -> bfloat16 cast
    and the CPU's give NaNs other payloads)."""
    if x.dtype != y.dtype or x.shape != y.shape:
        return False
    if not x.is_floating_point():
        return torch.equal(x, y)
    nx, ny = x.isnan(), y.isnan()
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
    return torch.equal(nx, ny) and torch.equal(x.view(bits)[~nx],
                                               y.view(bits)[~ny])


def _gr_err(x, y) -> float:
    """max |x - y| where neither is NaN (0 where nothing is left)."""
    d = (x.double() - y.double()).abs()
    d = d[~d.isnan()]
    return d.max().item() if d.numel() else 0.0


def _gr_routes(route, b: int, n: int, k: int, c: int) -> list:
    """The routes of a (b, n, k, c) "extrema" call in f32 and bf16, as
    "kind/parts/cluster"."""
    return ["/".join(str(v) for v in route(b, n, k, c, t))
            for t in (torch.float32, torch.bfloat16)]


def _time_gr_call(key: str) -> dict:
    """A main-path call phase 16 does not time (say the entry point's
    evaluation of a few clouds), timed on a random graph of its shape:
    kernel equal to plain first."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import (
        gather_reduce, gather_reduce_plain, route)
    want, dt, shape = key.split("_")
    b, n, k, c = (int(v) for v in shape.split("x"))
    g = torch.Generator(device="cuda").manual_seed(b * n + k + c)
    idx = torch.randint(0, n, (b, n, k), generator=g, device="cuda",
                        dtype=torch.int32)
    a = torch.randn((b, n, c), generator=g, device="cuda").to(
        getattr(torch, dt))
    if not all(torch.equal(x, y) for x, y in zip(
            gather_reduce(a, idx, want), gather_reduce_plain(a, idx, want))):
        raise AssertionError(f"gather_reduce {key}: kernel differs from "
                             "plain")
    ops = idx.numel() * c * (5 if want == "all" else
                             2 if want == "extrema" else 1)
    bound, by = bound_ms(_gr_bytes(a, idx, want), ops)
    t = {"ms": median_ms(lambda: gather_reduce(a, idx, want)),
         "card_ms": graph_ms(lambda: gather_reduce(a, idx, want)),
         "plain_ms": median_ms(lambda: gather_reduce_plain(a, idx, want),
                               reps=3, inner=1, warm=1),
         "library_ms": None, "bound_ms": bound, "bound_by": by,
         "graph": "random", "route": route(b, n, k, c, a.dtype, want).kind}
    print(f"gather_reduce {key} (random graph): kernel == plain; kernel "
          f"{t['ms']:.4f} ms ({t['card_ms']:.4f} on the card alone), plain "
          f"{t['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}); "
          f"{t['route']} route", flush=True)
    return t


def gr_by_call(calls: dict, timings: dict) -> dict:
    """The gather-reduce's main-path launches priced by call: each call's
    launches with its own time and bound (phase 16's, or for a call it
    does not time, `_time_gr_call`'s, added to `timings`), and launches x
    (ms - bound ms)."""
    out = {}
    for key, n in sorted(calls.items()):
        if key not in timings:
            timings[key] = _time_gr_call(key)
        t = timings[key]
        out[key] = {"launches": n, "ms": t["ms"], "card_ms": t["card_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "library_ms": t["library_ms"], "route": t["route"],
                    "gap_ms": n * (t["ms"] - t["bound_ms"])}
    return out


def phase_bf16_train(ks, knn_cuda, card: str):
    """The bf16 training slice at full width: 10 timed warm steps in each
    routing (the harness of train/profile_step.py with dtype=bf16), then
    the entry point with --amp true (3 epochs of fold 0). Counts are reset
    before and read after; returns them with the timings."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       export_jax_variables,
                                                       load_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, canonical_data, make_step, time_steps)
    timing = {}
    with tempfile.TemporaryDirectory() as tmp:
        _reset(ks, knn_cuda)
        ds, loss_fn = canonical_data()
        for fused in ("0", "1"):
            os.environ["FSEG_FUSED_EDGE"] = fused
            step = make_step(ds, loss_fn, tmp, dtype=torch.bfloat16)
            for _ in range(WARM):
                step()
            before = _counts(ks, knn_cuda)
            ms, peak, losses = time_steps(step)
            after = _counts(ks, knn_cuda)
            if not torch.isfinite(torch.stack(losses)).all():
                raise AssertionError(f"bf16 train: non-finite loss ({fused})")
            name = "fused" if fused == "1" else "unfused"
            launched = {k: after[k] - before[k] for k in after}
            timing[name] = {"ms_per_step": ms, "clouds_per_s": 32e3 / ms,
                            "peak_bytes": peak,
                            "launches_10_steps": launched}
            print(f"bf16 train: {name} step {ms:.2f} ms ({32e3 / ms:.1f} "
                  f"clouds/s), peak {peak / 2 ** 30:.2f} GiB, launches in "
                  f"{STEPS} steps {launched} on {card}", flush=True)
        os.environ.pop("FSEG_FUSED_EDGE")
        for name, kernels in (("unfused", ("scatter_rows",)),
                              ("fused", ("scatter_rows", "scatter_routed",
                                         "scatter_count", "gather_reduce"))):
            for k in kernels:
                if timing[name]["launches_10_steps"][k] < STEPS:
                    raise AssertionError(f"bf16 train: {k} did not launch "
                                         f"in every {name} step")
            if timing[name]["launches_10_steps"]["transpose"] != STEPS:
                raise AssertionError(f"bf16 train: {name}: not one "
                                     "transpose a step")
        t0 = time.perf_counter()
        if train_point_seg.main(AMP_TRAIN_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("bf16 train: the entry point failed")
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        if len(hist) != 3 or not np.isfinite(hist).all():
            raise AssertionError(f"bf16 train: loss history {hist}")
        model = load_model(os.path.join(fold, "model.pt"), DGCNNSeg)
        if model.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 train: model.pt holds a "
                                 f"{model.dtype} model")
        stats = export_jax_variables(model)["batch_stats"]
        still = [name for name, leaf in _leaves(stats)
                 if np.array_equal(leaf, np.zeros_like(leaf))
                 or np.array_equal(leaf, np.ones_like(leaf))]
        if still:
            raise AssertionError(f"bf16 train: running statistics never "
                                 f"moved: {still}")
        print(f"bf16 train: entry point --amp true (3 epochs, fold 0) in "
              f"{time.perf_counter() - t0:.1f} s; loss history {hist}",
              flush=True)
    return {**_counts(ks, knn_cuda),
            "k4_calls": _check_k4_route(ks, "bf16 train")}, timing


def _rel_l2(got: dict, want: dict) -> float:
    gap = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    return float(gap / max(np.sqrt(sum(np.sum(want[k] ** 2) for k in want)),
                           1e-30))


@contextlib.contextmanager
def planted_fault(route: str):
    """A wrong neighbour in the backward, for as long as the context lasts:
    the fused core routes each (n, c) to the slot after its extremal one,
    the unfused route's K2 scatters each edge's cotangent to the next
    slot's neighbour. The forward is unchanged."""
    from fissure_segmentation_tpu_torch.ops import edge, fused_edge
    if route == "fused":
        mod, name = fused_edge, "gather_reduce"
        real = fused_edge.gather_reduce

        def fault(a, idx, want="max"):
            out = real(a, idx, want)
            if want != "all":
                return out
            k = idx.shape[-1]
            return out[:2] + ((out[2] + 1) % k, (out[3] + 1) % k) + out[4:]
    else:
        mod, name = edge, "scatter_rows"
        real = edge.scatter_rows

        def fault(idx, g, n, transposed=None):
            # the caller's transpose is of the true graph: build the
            # rolled one's instead
            b, e = idx.shape
            rolled = idx.view(b, n, e // n).roll(1, -1).reshape(b, e)
            return real(rolled.contiguous(), g, n)
    setattr(mod, name, fault)
    try:
        yield
    finally:
        setattr(mod, name, real)


def phase_bf16_reference():
    """One bf16 train step at B=2, N=256, k=8 on the card (kernels) and on
    the CPU (plain versions), same weights (`_reference_model` in bf16),
    same batch, both routings; then the eval logits of the same model.

    bf16 keeps 8 bits of mantissa: each product's result is rounded to
    2^-9 relative, and the card (cuBLAS) and the CPU sum a product's terms
    in float32 in other orders before that rounding, so now and then an
    element rounds to the neighbouring bf16 value on one side, and later
    layers carry that step on. The forward is held as the CPU tests hold
    the port's bf16 model against JAX's (tests/test_torch_bf16.py): eval
    logits within BF16_TOL["logits"] * max|logit|, the loss and its
    components within rtol BF16_TOL["loss"], the running statistics within
    BF16_TOL["stats_rel_l2"] in relative L2. The backward rounds every
    cotangent to bf16 and each train-mode BatchNorm backward subtracts two
    batch means from it, so those steps grow layer by layer towards the
    input: the whole gradient is held within BF16_TOL["grad_rel_l2"] in
    relative L2, a limit between the sound step's readings and those of
    the same step with a wrong neighbour planted in its backward
    (`planted_fault`; PERF.md has both). That control runs on the card in
    each routing and must miss the limit. No updated parameter is held:
    Adam's first step turns any sign flip of a near-zero gradient into a
    step of lr."""
    from fissure_segmentation_tpu_torch.data.dataset import PointDataset
    from fissure_segmentation_tpu_torch.data.store import sample_batch
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    ds = PointDataset(make_synthetic_dataset(3, n_points=600),
                      sample_points=256)
    store = ds.to_store(device="cuda")
    cw = torch.as_tensor(ds.get_class_weights())
    model0 = _reference_model(0, ds, dtype=torch.bfloat16)
    x, y = sample_batch(store, torch.tensor([0, 2], device="cuda"),
                        ds.sample_points,
                        torch.Generator(device="cuda").manual_seed(100))
    for fused in ("0", "1"):
        os.environ["FSEG_FUSED_EDGE"] = fused
        route = "fused" if fused == "1" else "unfused"
        m_g, l_g, c_g, _ = _reference_step("cuda", model0, ds, cw,
                                           TrainConfig(), x, y)
        m_c, l_c, c_c, _ = _reference_step("cpu", model0, ds, cw,
                                           TrainConfig(), x, y)
        _close("bf16 loss", l_g, l_c, rtol=BF16_TOL["loss"], atol=0)
        for k in c_c:
            _close(f"bf16 {k}", c_g[k], c_c[k], rtol=BF16_TOL["loss"], atol=0)
        g_c = dict(_leaves(export_jax_variables(m_c, grad=True)))
        grad = _rel_l2(dict(_leaves(export_jax_variables(m_g, grad=True))),
                       g_c)
        grad_tol = BF16_TOL["grad_rel_l2"]
        with planted_fault(route):
            m_f = _reference_step("cuda", model0, ds, cw, TrainConfig(), x,
                                  y)[0]
        fault = _rel_l2(dict(_leaves(export_jax_variables(m_f, grad=True))),
                        g_c)
        if fault <= grad_tol:
            raise AssertionError(f"bf16 reference ({route}): a planted wrong "
                                 f"neighbour moved the gradient only "
                                 f"{fault:.3g} (tolerance {grad_tol:.3g})")
        v_g = dict(_leaves(export_jax_variables(m_g)["batch_stats"]))
        v_c = dict(_leaves(export_jax_variables(m_c)["batch_stats"]))
        stats = _rel_l2(v_g, v_c)
        if grad > grad_tol or stats > BF16_TOL["stats_rel_l2"]:
            raise AssertionError(f"bf16 reference ({route}): gradient "
                                 f"{grad:.3g} (tolerance {grad_tol:.3g}), "
                                 f"running statistics {stats:.3g} apart in "
                                 "relative L2")
        with torch.no_grad():
            lg = copy.deepcopy(model0).cuda().eval()(x).float().cpu()
            lc = copy.deepcopy(model0).eval()(x.cpu()).float()
        gap = float((lg - lc).abs().max() / lc.abs().max())
        if gap > BF16_TOL["logits"]:
            raise AssertionError(f"bf16 reference ({route}): eval logits "
                                 f"{gap:.3g} * max|logit| apart")
        print(f"bf16 reference: {route} step card vs CPU: loss {l_g:.6f} vs "
              f"{l_c:.6f}; gradient {grad:.4g} apart (relative L2, "
              f"tolerance {grad_tol:.3g}; with the planted fault "
              f"{fault:.4g}), running statistics {stats:.3g} apart; eval "
              f"logits {gap:.3g} * max|logit| apart (tolerances {BF16_TOL})",
              flush=True)
    os.environ.pop("FSEG_FUSED_EDGE")


def phase_probes(card: str):
    """The probes of P1-P4 (prof/probes.py) at 3 repetitions (each variant
    held against plain first), then the stream kernels' headline times
    beside their plain version, torch.sum(g) to a scalar, torch.sum(., 0)
    and the bound, then their hard cases (`probes.hard_cases`: rows under
    the grid and off every tile, L = 4 ... 1024, the smallest and largest
    ring; launches back to back and on two streams at once bit-equal and
    equal to the order's replay). The path's launches are those of the
    probes' timed calls (each row counts its own; the checks are not
    counted). Returns ({kernel: launches}, rows, {kernel: timings})."""
    from fissure_segmentation_tpu_torch.kernels.stream import (
        stream_sum, stream_sum_async, stream_sum_plain)
    from fissure_segmentation_tpu_torch.prof import probes
    idx, g = probes.payload()
    rows = (probes.p1(idx, g, reps=3) + probes.p2_p4(g, reps=3)
            + probes.p3(g, reps=3))
    counts = {}
    for row in rows:
        for name, n in row["launches"].items():
            counts[name] = counts.get(name, 0) + n
    g64, g128 = g.view(-1, 64), g.view(-1, 128)
    ring = min((r for r in rows if "stream_sum_async" in r["variant"]),
               key=lambda r: r["ms"])
    chunk, nbuf = (int(t[2:]) for t in ring["variant"].split()[-2:])
    heads = {}
    for name, view, fn, row in (
            ("stream_sum", g64, lambda: stream_sum(g64),
             next(r for r in rows if r["variant"].startswith("k_stream"))),
            ("stream_sum_async", g128,
             lambda: stream_sum_async(g128, chunk, nbuf), ring)):
        t_p = median_ms(lambda: stream_sum_plain(view), reps=3)
        t_l = median_ms(lambda: torch.sum(view, 0, dtype=torch.float32),
                        reps=3)
        t_t = median_ms(lambda: torch.sum(g, dtype=torch.float32), reps=3)
        # read the view once, write L f32; one add per element
        bound, by = bound_ms(view.numel() * 2 + view.shape[1] * 4,
                             view.numel())
        heads[name] = {"ms": row["ms"], "plain_ms": t_p, "library_ms": t_l,
                       "library_total_ms": t_t, "bound_ms": bound,
                       "bound_by": by, "max_abs_err": row["max_abs_err"],
                       "shape": list(view.shape), "variant": row["variant"],
                       "gb_per_s": row["gb_per_s"]}
        print(f"{name} {row['variant']}: kernel {row['ms']:.4f} ms "
              f"({row['gb_per_s']:.1f} GB/s), plain {t_p:.4f} ms, library "
              f"torch.sum(g) {t_t:.4f} ms, torch.sum(., 0) {t_l:.4f} ms, "
              f"bound {bound:.4f} ms ({by}) on {card}", flush=True)
    hard = probes.hard_cases()
    print(f"stream kernels' hard cases: {len(hard)} held, "
          f"{json.dumps(hard)}", flush=True)
    return counts, rows, heads


# ---- the default run of train_point_seg (phases 20 and 21) --------------

RESULT_ROWS = ["Class", "Mean Dice", "StdDev Dice", None, "Fissure",
               "Mean ASSD", "StdDev ASSD", "Mean SDSD", "StdDev SDSD",
               "Mean HD", "StdDev HD", "Mean HD95", "StdDev HD95",
               "proportion missing"]
SPEED_HEADER = ["Inference", "Inference_std", "Post-Processing",
                "Post-Processing_std", "Total", "Total_std"]
# phase_dynamic_reference says why
DYN_TOL = {"loss": 1e-4, "grad_rel_l2": 1e-3, "logits": 1e-3,
           "graph_share": 0.99}
DYN_BF16_TOL = {"logits": 0.15, "loss": 5e-2, "slack": 1.3}
PIPE_TOL = {"pred_share": 0.98, "dice": 0.02, "mesh_rtol": 0.15}


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _check_test_outputs(test_dir: str, suffix: str, what: str):
    """The JAX package's CSV layout, finite Dice, a finite ASSD for every
    fissure that is not missing; returns (inference s/case, post-processing
    s/case) from inference_time{suffix}.csv."""
    rows = _csv(os.path.join(test_dir, f"test_results{suffix}.csv"))
    if [r[0] if r else None for r in rows] != RESULT_ROWS:
        raise AssertionError(f"{what}: test_results{suffix}.csv layout "
                             f"{[r[:1] for r in rows]}")
    if not np.isfinite(np.asarray(rows[1][1:], float)).all():
        raise AssertionError(f"{what}: Dice {rows[1]}")
    per = {}
    for name in ("dice", "assd"):
        per[name] = _csv(os.path.join(test_dir,
                                      f"{name}_per_instance{suffix}.csv"))
        if per[name][0] != ["ID", "fissure 1", "fissure 2", "fissure 3",
                            "mean"] or len(per[name]) < 2:
            raise AssertionError(f"{what}: {name}_per_instance layout")
    missing = np.asarray(rows[-1][1:-1], float)
    assd = np.asarray([r[1:4] for r in per["assd"][1:]], float)
    n_cases = assd.shape[0]
    if not np.array_equal(np.isfinite(assd).sum(0),
                          np.round(n_cases * (1 - missing)).astype(int)):
        raise AssertionError(f"{what}: ASSD {assd.tolist()} against the "
                             f"missing shares {missing.tolist()}")
    speed = _csv(os.path.join(test_dir, f"inference_time{suffix}.csv"))
    if speed[0] != SPEED_HEADER or not all(
            np.isfinite(float(v)) for v in speed[1]):
        raise AssertionError(f"{what}: inference_time{suffix}.csv {speed}")
    return float(speed[1][0]), float(speed[1][2])


def phase_default_run(ks, knn_cuda, card: str):
    """The default run of the entry point at full width: train_point_seg
    .main with no --static and no --train_only (DGCNNSeg(k=40, dynamic,
    bf16), batch 32 x 2048, 3 epochs of fold 0, then fold 0's test), then
    --test_only, --speed and --copd on the same output; then 10 timed warm
    dynamic bf16 steps and the feature graph alone. Counts are reset before
    and read after the runs and steps (before the feature graph is timed
    alone); returns (counts, timing, gather-reduce calls, K4 calls, the
    fused row selection's calls)."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       export_jax_variables,
                                                       load_model)
    from fissure_segmentation_tpu_torch.ops.knn import feature_knn
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, canonical_data, make_step, time_steps)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    timing = {}
    _reset(ks, knn_cuda)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if train_point_seg.main(DEFAULT_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("default run: the entry point failed")
        timing["train_and_test_s"] = time.perf_counter() - t0
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        if len(hist) != 3 or not np.isfinite(hist).all():
            raise AssertionError(f"default run: loss history {hist}")
        model = load_model(os.path.join(fold, "model.pt"), DGCNNSeg)
        if not model.dynamic or model.dtype != torch.bfloat16:
            raise AssertionError(f"default run: model.pt holds {model.config}")
        stats = export_jax_variables(model)["batch_stats"]
        if any(np.array_equal(leaf, np.zeros_like(leaf))
               or np.array_equal(leaf, np.ones_like(leaf))
               for _, leaf in _leaves(stats)):
            raise AssertionError("default run: running statistics never "
                                 "moved")
        test_dir = os.path.join(fold, "test")
        inf, post = _check_test_outputs(test_dir, "", "default run")
        pred = os.path.join(test_dir, "test_predictions")
        objs = os.listdir(os.path.join(pred, "meshes"))
        niftis = os.listdir(os.path.join(pred, "labelmaps"))
        if not objs or len(niftis) != 4 or not os.path.exists(
                os.path.join(tmp, "cv_results.csv")):
            raise AssertionError(f"default run: artifacts {objs} {niftis}")
        timing.update(inference_s_per_case=inf, post_s_per_case=post,
                      loss_history=hist, objs=len(objs))
        print(f"default run: trained and tested fold 0 in "
              f"{timing['train_and_test_s']:.1f} s; loss history {hist}; "
              f"test: {inf:.4f} s/case inference, {post:.4f} s/case "
              f"post-processing; {len(objs)} OBJ, {len(niftis)} NIfTI "
              f"on {card}", flush=True)
        for extra in (["--test_only", "--fold", "0"], ["--speed"],
                      ["--copd", "--fold", "0"]):
            t0 = time.perf_counter()
            if train_point_seg.main(["--output", tmp] + extra) != 0:
                raise AssertionError(f"default run: {extra[0]} failed")
            name = extra[0].lstrip("-")
            timing[f"{name}_s"] = time.perf_counter() - t0
            if name == "test_only":
                timing["test_only"] = _check_test_outputs(
                    test_dir, "", "--test_only")
            elif name == "copd":
                timing["copd"] = _check_test_outputs(test_dir, "_copd",
                                                     "--copd")
                if not os.path.exists(os.path.join(tmp,
                                                   "cv_results_copd.csv")):
                    raise AssertionError("--copd: no cv_results_copd.csv")
            else:
                speed = _csv(os.path.join(tmp, "inference_time.csv"))
                if speed[0] != SPEED_HEADER:
                    raise AssertionError(f"--speed: {speed}")
                timing["speed_ms"] = float(speed[1][0]) * 1e3
                timing["speed_std_ms"] = float(speed[1][1]) * 1e3
            print(f"default run: {extra[0]} in {timing[name + '_s']:.1f} s "
                  f"({timing.get(name, timing.get('speed_ms'))})",
                  flush=True)

        ds, loss_fn = canonical_data()
        step = make_step(ds, loss_fn, tmp, dtype=torch.bfloat16,
                         dynamic=True)
        for _ in range(WARM):
            step()
        before = _counts(ks, knn_cuda)
        ms, peak, losses = time_steps(step)
        after = _counts(ks, knn_cuda)
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError("default run: non-finite loss in the timed "
                             "steps")
    launched = {k: after[k] - before[k] for k in after}
    if launched["transpose"] != 3 * STEPS:
        raise AssertionError(f"default run: {launched['transpose']} graph "
                             f"transposes in {STEPS} steps, not three a step")
    for k, n in (("knn", 1), ("scatter_rows", 1), ("scatter_routed", 2),
                 ("scatter_count", 2), ("gather_reduce", 2),
                 ("select_rows", 2)):
        if launched[k] < n * STEPS:
            raise AssertionError(f"default run: {k} launched "
                                 f"{launched[k]} times in {STEPS} steps")
    counts = _counts(ks, knn_cuda)
    for k in ("knn", "transpose", "scatter_rows", "scatter_routed",
              "scatter_count", "gather_reduce", "select_rows"):
        if counts[k] < 1:
            raise AssertionError(f"default run: {k} never launched")
    calls = (_gr_calls(ks, knn_cuda), _check_k4_route(ks, "default run"),
             dict(_wrappers(ks, knn_cuda)["select_rows"].calls))
    feats = torch.randn((32, 2048, 64), device="cuda").to(torch.bfloat16)
    graph_ms = median_ms(lambda: feature_knn(feats, 40), reps=5, inner=3)
    timing.update(ms_per_step=ms, clouds_per_s=32e3 / ms, peak_bytes=peak,
                  launches_10_steps=launched,
                  feature_graph_ms_per_call=graph_ms,
                  feature_graph_ms_per_step=2 * graph_ms)
    print(f"default run: dynamic bf16 step {ms:.2f} ms ({32e3 / ms:.1f} "
          f"clouds/s), peak {peak / 2 ** 30:.2f} GiB, launches in {STEPS} "
          f"steps {launched}; the feature graph (32, 2048, 64) bf16 k=40 "
          f"{graph_ms:.3f} ms a call, {2 * graph_ms:.3f} ms a step, on "
          f"{card}", flush=True)
    return (counts, timing, *calls)


@contextlib.contextmanager
def planted_graph_fault():
    """A wrong neighbour in every feature graph, for as long as the context
    lasts: slot 1 of each point takes the slot-1 neighbour of the next
    point."""
    from fissure_segmentation_tpu_torch.ops import knn as knn_mod
    real = knn_mod.feature_knn

    def fault(x, kk, *args):
        idx, dist = real(x, kk, *args)
        idx = idx.clone()
        idx[..., 1] = idx[..., 1].roll(1, dims=-1)
        return idx, dist
    knn_mod.feature_knn = fault
    try:
        yield
    finally:
        knn_mod.feature_knn = real


class GraphRecorder:
    """Records every feature graph the model builds (ops/knn.py:
    feature_knn) while the context lasts."""

    def __enter__(self):
        from fissure_segmentation_tpu_torch.ops import knn as knn_mod
        self.mod, self.real, self.graphs = knn_mod, knn_mod.feature_knn, []

        def record(x, kk, *args):
            out = self.real(x, kk, *args)
            self.graphs.append(out[0].cpu())
            return out
        knn_mod.feature_knn = record
        return self

    def __exit__(self, *exc):
        self.mod.feature_knn = self.real


def _same_sets(a, b) -> float:
    return float((a.sort(-1).values == b.sort(-1).values).all(-1)
                 .float().mean())


def _gt_bias(case, scale: float, device):
    """A class bias of `scale` on the GT label of the case point that each
    input point equals (the ensemble feeds case points)."""
    pts = torch.as_tensor(case["coords"], device=device)
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(case["labels"], device=device).long(), 4).float()

    def bias(x):
        d = ((x[..., None, :3] - pts) ** 2).sum(-1)
        return onehot[d.argmin(-1)] * scale
    return bias


def phase_dynamic_reference(card: str):
    """Card against CPU on the default run's new path, at a small size.

    1. A dynamic DGCNNSeg(k=8) from seeded weights (B=2, N=256): one float32
       step on the card and on the CPU from the same weights and batch.
       With TF32 off both build the same feature graphs but for near-ties:
       at least DYN_TOL["graph_share"] of the neighbour sets agree; the
       loss within rtol DYN_TOL["loss"], the whole gradient within
       DYN_TOL["grad_rel_l2"] relative L2, the eval logits within
       DYN_TOL["logits"] * max|logit|. The same step on the card with a
       wrong neighbour planted in every feature graph
       (`planted_graph_fault`) must miss the gradient limit. First
       readings (NVIDIA H100 80GB HBM3, 700 W): share 1.0, loss 5.3e-7,
       gradient 3.6e-4 (the planted fault 1.09), logits 9.1e-7.
    2. The same weights in bf16: the graph is computed from bf16 features,
       where the card's and the CPU's products round differently and move
       neighbours (tests/test_torch_dynamic.py), so the bf16 step is held
       as the CPU tests hold it against JAX: the card's bf16 loss within
       rtol DYN_BF16_TOL["loss"] of the CPU's bf16 loss, its gradient no
       further from the CPU's float32 gradient than the CPU's bf16 gradient
       is (x DYN_BF16_TOL["slack"]), its eval logits within
       DYN_BF16_TOL["logits"] * max|logit| of the CPU's bf16 logits (this
       runs the fused eval route in bf16, "extrema", on the card). First
       readings: loss 3.4e-3, gradient 0.742 against the CPU's 0.729,
       logits 0.021.
    3. test_pipeline on one case of 3000 points (512-point subsets, 8
       runs, 64^3) with the bf16 weights plus a GT-keyed class bias (0.3:
       on the CPU the prediction follows the GT at all but 2 points, the
       model at those; at 0.25 class 0 takes whole fissures), the same
       injected draws on both sides: the per-point predictions agree on at
       least PIPE_TOL["pred_share"], Dice within PIPE_TOL["dice"], the
       ASSD family within PIPE_TOL["mesh_rtol"] where both are finite (a
       handful of points predicted otherwise move the fitted mesh: first
       readings 3 of 3000 points, Dice 0.0043, ASSD 0.069, SDSD 0.051, HD
       0.023, HD95 0.039 apart); the card's run with every surface sample
       shifted by one voxel must miss that limit (first reading: ASSD
       0.45)."""
    from fissure_segmentation_tpu_torch.data.dataset import PointDataset
    from fissure_segmentation_tpu_torch.data.store import sample_batch
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    from fissure_segmentation_tpu_torch.models.ensemble import build_subsets
    from fissure_segmentation_tpu_torch.train import evaluation
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    ds = PointDataset(make_synthetic_dataset(3, n_points=600),
                      sample_points=256)
    store = ds.to_store(device="cuda")
    cw = torch.as_tensor(ds.get_class_weights())
    x, y = sample_batch(store, torch.tensor([0, 2], device="cuda"),
                        ds.sample_points,
                        torch.Generator(device="cuda").manual_seed(100))
    out = {}

    def grads(m):
        return dict(_leaves(export_jax_variables(m, grad=True)))

    # 1. float32
    model0 = _reference_model(0, ds, dynamic=True)
    with GraphRecorder() as rec_g:
        m_g, l_g, _, _ = _reference_step("cuda", model0, ds, cw,
                                         TrainConfig(), x, y)
    with GraphRecorder() as rec_c:
        m_c, l_c, _, _ = _reference_step("cpu", model0, ds, cw,
                                         TrainConfig(), x, y)
    share = min(_same_sets(a, b) for a, b in zip(rec_g.graphs,
                                                 rec_c.graphs))
    g_c = grads(m_c)
    grad = _rel_l2(grads(m_g), g_c)
    with planted_graph_fault():
        m_f = _reference_step("cuda", model0, ds, cw, TrainConfig(), x, y)[0]
    fault = _rel_l2(grads(m_f), g_c)
    with torch.no_grad():
        lg = copy.deepcopy(model0).cuda().eval()(x).cpu()
        lc = copy.deepcopy(model0).eval()(x.cpu())
    logits = float((lg - lc).abs().max() / lc.abs().max())
    loss = abs(l_g - l_c) / abs(l_c)
    out["f32"] = dict(graph_share=share, loss_rel=loss, grad_rel_l2=grad,
                      planted_fault_grad_rel_l2=fault, logits=logits)
    if (share < DYN_TOL["graph_share"] or loss > DYN_TOL["loss"]
            or grad > DYN_TOL["grad_rel_l2"] or logits > DYN_TOL["logits"]):
        raise AssertionError(f"dynamic reference (f32): {out['f32']} "
                             f"against {DYN_TOL}")
    if fault <= DYN_TOL["grad_rel_l2"]:
        raise AssertionError(f"dynamic reference: a planted wrong neighbour "
                             f"moved the gradient only {fault:.3g}")
    print(f"dynamic reference: f32 step card vs CPU {out['f32']} "
          f"(limits {DYN_TOL})", flush=True)

    # 2. bf16
    model_b = _reference_model(0, ds, dtype=torch.bfloat16, dynamic=True)
    m_gb, l_gb, _, _ = _reference_step("cuda", model_b, ds, cw,
                                       TrainConfig(), x, y)
    m_cb, l_cb, _, _ = _reference_step("cpu", model_b, ds, cw,
                                       TrainConfig(), x, y)
    ours, own = _rel_l2(grads(m_gb), g_c), _rel_l2(grads(m_cb), g_c)
    with torch.no_grad():
        lgb = copy.deepcopy(model_b).cuda().eval()(x).float().cpu()
        lcb = copy.deepcopy(model_b).eval()(x.cpu()).float()
    logits_b = float((lgb - lcb).abs().max() / lcb.abs().max())
    loss_b = abs(l_gb - l_cb) / abs(l_cb)
    out["bf16"] = dict(loss_rel=loss_b, grad_vs_cpu_f32=ours,
                       cpu_bf16_vs_cpu_f32=own, logits=logits_b)
    if (loss_b > DYN_BF16_TOL["loss"] or logits_b > DYN_BF16_TOL["logits"]
            or ours > DYN_BF16_TOL["slack"] * own):
        raise AssertionError(f"dynamic reference (bf16): {out['bf16']} "
                             f"against {DYN_BF16_TOL}")
    print(f"dynamic reference: bf16 step card vs CPU {out['bf16']} "
          f"(limits {DYN_BF16_TOL})", flush=True)

    # 3. test_pipeline
    case = make_synthetic_dataset(1, n_points=3000, gt_surfaces=True,
                                  seed=5)[0]
    tds = PointDataset([case], sample_points=512)
    g = torch.Generator().manual_seed(9)
    draws = [{"subsets": build_subsets(3000, 512, 8, g),
              "surface": {c: (torch.rand(4000, generator=g),
                              torch.rand((4000, 2), generator=g))
                          for c in (1, 2, 3)}}]
    runs = {}
    real_eval = evaluation.evaluate_case
    real_sample = evaluation.sample_points_on_triangles
    for name, dev in (("card", "cuda"), ("cpu", "cpu"), ("fault", "cuda")):
        net = copy.deepcopy(model_b).to(dev).eval()
        bias = _gt_bias(case, 0.3, dev)
        preds = []

        def record(pred, *a, **k):
            preds.append(np.asarray(pred))
            return real_eval(pred, *a, **k)

        def shifted(*a, **k):
            return real_sample(*a, **k) + 1.0
        evaluation.evaluate_case = record
        if name == "fault":
            evaluation.sample_points_on_triangles = shifted
        try:
            with tempfile.TemporaryDirectory() as tmp:
                res = evaluation.test_pipeline(
                    tds, lambda v, net=net, bias=bias: net(v) + bias(v), tmp,
                    sample_points=512, n_runs_min=8, device=dev,
                    draws=draws)
        finally:
            evaluation.evaluate_case = real_eval
            evaluation.sample_points_on_triangles = real_sample
        runs[name] = (preds[0], res)
    (p_g, r_g), (p_c, r_c), (_, r_f) = runs["card"], runs["cpu"], \
        runs["fault"]

    def mesh_gaps(a, b):
        both = np.isfinite(a["assd"]) & np.isfinite(b["assd"])
        return {k: float((np.abs(a[k] - b[k]) / np.abs(b[k]))[both].max())
                for k in ("assd", "sdsd", "hd", "hd95")}, int(both.sum())
    pred_share = float((p_g == p_c).mean())
    dice = float(np.abs(r_g["dice"] - r_c["dice"]).max())
    gaps, n_fitted = mesh_gaps(r_g, r_c)
    fault_gaps = mesh_gaps(r_f, r_c)[0]
    mesh, fault_mesh = max(gaps.values()), max(fault_gaps.values())
    out["pipeline"] = dict(pred_share=pred_share, dice_gap=dice,
                           mesh_rel_gaps=gaps, fissures_fitted=n_fitted,
                           classes=np.bincount(p_c, minlength=4).tolist(),
                           dice=r_c["dice"].tolist(),
                           shifted_sample_mesh_rel_gaps=fault_gaps)
    if (pred_share < PIPE_TOL["pred_share"] or dice > PIPE_TOL["dice"]
            or n_fitted < 2 or mesh > PIPE_TOL["mesh_rtol"]):
        raise AssertionError(f"dynamic reference (test_pipeline): "
                             f"{out['pipeline']} against {PIPE_TOL}")
    if fault_mesh <= PIPE_TOL["mesh_rtol"]:
        raise AssertionError(f"dynamic reference: shifted surface samples "
                             f"moved the ASSD family only {fault_mesh:.3g}")
    print(f"dynamic reference: test_pipeline card vs CPU {out['pipeline']} "
          f"(limits {PIPE_TOL}) on {card}", flush=True)
    return out


# ---- the PC-AE and DSEG-AE (phases 22-25) -------------------------------

# the JAX entry's defaults: k = 20, 1024 points, latent 512, plane, batch 32
PCAE_ARGV = ["--ds", "synthetic", "--fold", "0", "--batch", "32", "--pts",
             "1024", "--k", "20", "--latent", "512", "--shape", "plane"]
# the DGCNNSeg fold DSEG-AE composes: the default run (dynamic, bf16) with
# --train_only, trained long enough that every validation case yields a
# reconstructed fissure (phase_dseg checks it)
SEG_ARGV = ["--ds", "synthetic", "--fold", "0", "--epochs", "40", "--pts",
            "2048", "--k", "40", "--batch", "32", "--train_only"]
# phase_pcae_reference and phase_dseg_reference say why
PCAE_TOL = {"loss": 1e-4, "grad_rel_l2": 1e-3, "eval": 1e-4,
            "graph_share": 0.99}
DSEG_TOL = {"label_share": 0.98, "graph_share": 0.95, "rel_l2": 1e-3,
            "padded": 1e-5}


def _check_reconstruction(out: str, what: str) -> float:
    rows = _csv(os.path.join(out, "fold0", "test",
                             "reconstruction_chamfer.csv"))
    if rows[0] != ["mean_chamfer", "std_chamfer"] or not np.isfinite(
            np.asarray(rows[1], float)).all():
        raise AssertionError(f"{what}: reconstruction_chamfer.csv {rows}")
    cv = _csv(os.path.join(out, "cv_results.csv"))
    if cv[0] != ["fold", "chamfer"] or cv[-1][0] != "mean":
        raise AssertionError(f"{what}: cv_results.csv {cv}")
    return float(rows[1][0])


def _slice_calls(ks, knn_cuda) -> dict:
    """K1's, K2's and K5's launches by call since the last reset."""
    from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda
    return {"knn": dict(knn_cuda.calls),
            "scatter_rows": dict(ks.scatter_rows.calls),
            "fps": dict(fps_cuda.calls)}


def phase_pcae(ks, knn_cuda, card: str, out_dir: str):
    """The PC-AE entry at full width (PCAE_ARGV): --mesh trains fold 0 for
    3 epochs, the point target for 1, each then tested; finite losses,
    model.pt (a DGCNNFoldingNet, the class recorded), reconstruction_
    chamfer.csv and cv_results.csv. Then 10 timed warm steps each of the
    dynamic mesh, dynamic point and static mesh steps (train_pc_ae.
    make_step): ms/step, clouds/s, peak memory and launches (a dynamic
    step: K1 once, the transpose 4 times, K2 4 times; a static step: K1
    and the transpose once, K2 4 times). Counts are reset before and read
    after; returns (counts, timing, calls by kernel)."""
    from fissure_segmentation_tpu_torch import train_pc_ae
    from fissure_segmentation_tpu_torch.cli import get_pc_ae_train_parser
    from fissure_segmentation_tpu_torch.models import (DGCNNFoldingNet,
                                                       load_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, time_steps)
    timing = {}
    _reset(ks, knn_cuda)
    for name, extra, epochs in (("mesh", ["--mesh"], 3), ("points", [], 1)):
        out = os.path.join(out_dir, f"ae_{name}")
        t0 = time.perf_counter()
        if train_pc_ae.main(PCAE_ARGV + extra + ["--epochs", str(epochs),
                                                 "--output", out]) != 0:
            raise AssertionError(f"pcae ({name}): the entry point failed")
        took = time.perf_counter() - t0
        hist = _read_history(os.path.join(out, "fold0", "history.csv"))
        if len(hist) != epochs or not np.isfinite(hist).all():
            raise AssertionError(f"pcae ({name}): loss history {hist}")
        model = load_model(os.path.join(out, "fold0", "model.pt"))
        if not isinstance(model, DGCNNFoldingNet) or \
                model.decode_mesh != (name == "mesh"):
            raise AssertionError(f"pcae ({name}): model.pt holds "
                                 f"{type(model).__name__} {model.config}")
        chamfer = _check_reconstruction(out, f"pcae ({name})")
        timing[name] = {"train_and_test_s": took, "loss_history": hist,
                        "reconstruction_chamfer": chamfer}
        print(f"pcae: {name} target, {epochs} epoch(s) of fold 0 trained "
              f"and tested in {took:.1f} s; loss history {hist}; "
              f"reconstruction chamfer {chamfer:.5f}", flush=True)
    parser = get_pc_ae_train_parser()
    expect = {"dynamic": {"knn": 1, "transpose": 4, "scatter_rows": 4},
              "static": {"knn": 1, "transpose": 1, "scatter_rows": 4}}
    for name, extra in (("mesh_dynamic", ["--mesh"]),
                        ("points_dynamic", []),
                        ("mesh_static", ["--mesh", "--static"])):
        step = train_pc_ae.make_step(parser.parse_args(PCAE_ARGV + extra),
                                     out_dir, "cuda")
        for _ in range(WARM):
            step()
        before = _counts(ks, knn_cuda)
        ms, peak, losses = time_steps(step)
        after = _counts(ks, knn_cuda)
        if not torch.isfinite(torch.stack(losses)).all():
            raise AssertionError(f"pcae: non-finite loss ({name})")
        launched = {k: after[k] - before[k] for k in after}
        for k, n in expect[name.split("_")[1]].items():
            if launched[k] != n * STEPS:
                raise AssertionError(f"pcae {name}: {k} launched "
                                     f"{launched[k]} times in {STEPS} "
                                     f"steps, not {n} a step")
        timing[f"{name}_step"] = {
            "ms_per_step": ms, "clouds_per_s": 32e3 / ms,
            "peak_bytes": peak, "launches_10_steps": launched}
        print(f"pcae: {name} step {ms:.2f} ms ({32e3 / ms:.1f} clouds/s), "
              f"peak {peak / 2 ** 30:.2f} GiB, launches in {STEPS} steps "
              f"{launched} on {card}", flush=True)
    return _counts(ks, knn_cuda), timing, _slice_calls(ks, knn_cuda)


def _grads(model) -> dict:
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    return dict(_leaves(export_jax_variables(model, grad=True)))


def phase_pcae_reference(card: str):
    """The PC-AE step card against CPU at full width on a small input
    (B = 2, N = 256 dyadic points so m = 256, k = 20, latent 512, --mesh,
    the mesh loss with its fixed draws against 1024 target points): one
    forward and backward on each device from the same weights. With TF32
    off the coordinate graph is exact on both; the feature graphs of
    layers 1-3 (C = 64, 64, 128) are built from float32 features whose
    products round differently on the two devices, so at least
    PCAE_TOL["graph_share"] of their neighbour sets must agree; the loss
    within rtol PCAE_TOL["loss"], the whole gradient within
    PCAE_TOL["grad_rel_l2"] relative L2 (its Chamfer minima may break a
    near-tie either way), the eval vertices within PCAE_TOL["eval"] x
    max|v|. The same step on the card with a wrong neighbour planted in
    every feature graph must miss the gradient limit."""
    from fissure_segmentation_tpu_torch import train_pc_ae
    from fissure_segmentation_tpu_torch.cli import get_pc_ae_train_parser
    args = get_pc_ae_train_parser().parse_args(
        ["--pts", "256", "--k", "20", "--latent", "512", "--mesh"])
    g = torch.Generator().manual_seed(23)
    model0 = train_pc_ae.build_model(args, g)
    x = torch.randint(-32, 33, (2, 256, 3), generator=g) / 32.0
    y = torch.rand((2, 1024, 3), generator=g) * 2 - 1
    loss_fn = train_pc_ae.make_loss(args, model0)

    def step(dev):
        m = copy.deepcopy(model0).to(dev).train()
        loss, _ = loss_fn(m(x.to(dev)), y.to(dev))
        loss.backward()
        return m, float(loss)
    with GraphRecorder() as rec_g:
        m_g, l_g = step("cuda")
    with GraphRecorder() as rec_c:
        m_c, l_c = step("cpu")
    share = min(_same_sets(a, b) for a, b in zip(rec_g.graphs,
                                                 rec_c.graphs))
    g_c = _grads(m_c)
    grad = _rel_l2(_grads(m_g), g_c)
    with planted_graph_fault():
        fault = _rel_l2(_grads(step("cuda")[0]), g_c)
    with torch.no_grad():
        vg = copy.deepcopy(model0).cuda().eval()(x.cuda())[0].cpu()
        vc = copy.deepcopy(model0).eval()(x)[0]
    ev = float((vg - vc).abs().max() / vc.abs().max())
    out = dict(graph_share=share, graphs=len(rec_g.graphs),
               loss_rel=abs(l_g - l_c) / abs(l_c), grad_rel_l2=grad,
               planted_fault_grad_rel_l2=fault, eval=ev)
    if (len(rec_g.graphs) != 3 or share < PCAE_TOL["graph_share"]
            or out["loss_rel"] > PCAE_TOL["loss"]
            or grad > PCAE_TOL["grad_rel_l2"] or ev > PCAE_TOL["eval"]):
        raise AssertionError(f"pcae reference: {out} against {PCAE_TOL}")
    if fault <= PCAE_TOL["grad_rel_l2"]:
        raise AssertionError(f"pcae reference: a planted wrong neighbour "
                             f"moved the gradient only {fault:.3g}")
    print(f"pcae reference: step card vs CPU {out} (limits {PCAE_TOL}) on "
          f"{card}", flush=True)
    return out


def _copy_fold_as_fst(src: str, dst: str) -> None:
    """A fold directory's model re-written as model.fst through the port's
    writer (with its run's commandline_args.json and split), read back
    equal."""
    import shutil
    from fissure_segmentation_tpu_torch.models import (export_jax_variables,
                                                       load_fold_model,
                                                       save_fst)
    os.makedirs(os.path.join(dst, "fold0"))
    for name in ("commandline_args.json", "cross_val_split.json"):
        if os.path.exists(os.path.join(src, name)):
            shutil.copy(os.path.join(src, name), dst)
    model = load_fold_model(os.path.join(src, "fold0"))
    save_fst(model, os.path.join(dst, "fold0", "model.fst"))
    back = load_fold_model(os.path.join(dst, "fold0"))
    a, b = (dict(_leaves(export_jax_variables(m))) for m in (model, back))
    if back.config != model.config or a.keys() != b.keys() or not all(
            np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError(f"dseg: {src} read back from .fst differs")


@contextlib.contextmanager
def _cached_synthetic(module):
    """The entry's synthetic dataset generated once for the phase's runs
    (a copy for each run)."""
    real, memo = module.make_synthetic_dataset, {}

    def cached(*args, **kwargs):
        key = repr((args, sorted(kwargs.items())))
        if key not in memo:
            memo[key] = real(*args, **kwargs)
        return copy.deepcopy(memo[key])
    module.make_synthetic_dataset = cached
    try:
        yield
    finally:
        module.make_synthetic_dataset = real


def phase_dseg(ks, knn_cuda, card: str, ae_dir: str, out_dir: str):
    """DSEG-AE on the card (dseg_ae_regularization.run): the seg fold is
    trained here (SEG_ARGV: the default run's DGCNNSeg, dynamic bf16, 40
    epochs of fold 0), the AE is phase 22's --mesh fold. Three runs on fold
    0's 4 validation cases: --sampling farthest --pad_with_random_offsets
    from the model.pt folds, the same from both folds re-written as
    model.fst by the port's writer (equal outputs), and --sampling
    accumulate. Every case must yield at least one reconstructed fissure,
    every Chamfer distance be finite, and K1, K5 and the gather-reduce
    launch. Counts are reset after the seg training and read after the
    runs; returns (counts, timing, gather-reduce calls, calls by
    kernel)."""
    from fissure_segmentation_tpu_torch import (dseg_ae_regularization,
                                                train_point_seg)
    from fissure_segmentation_tpu_torch.cli import get_ae_reg_parser
    seg_dir = os.path.join(out_dir, "seg")
    timing = {}
    with _cached_synthetic(train_point_seg), \
            _cached_synthetic(dseg_ae_regularization):
        t0 = time.perf_counter()
        if train_point_seg.main(SEG_ARGV + ["--output", seg_dir]) != 0:
            raise AssertionError("dseg: training the seg fold failed")
        timing["seg_train_s"] = time.perf_counter() - t0
        seg_fst, ae_fst = (os.path.join(out_dir, f"{n}_fst")
                           for n in ("seg", "ae"))
        _copy_fold_as_fst(seg_dir, seg_fst)
        _copy_fold_as_fst(ae_dir, ae_fst)
        _reset(ks, knn_cuda)
        runs = {}
        for name, (sd, ad, extra) in {
                "farthest": (seg_dir, ae_dir, ["--sampling", "farthest",
                                               "--pad_with_random_offsets"]),
                "farthest_fst": (seg_fst, ae_fst,
                                 ["--sampling", "farthest",
                                  "--pad_with_random_offsets"]),
                "accumulate": (seg_dir, ae_dir,
                               ["--sampling", "accumulate"])}.items():
            before = _counts(ks, knn_cuda)
            (m,) = dseg_ae_regularization.run(get_ae_reg_parser().parse_args(
                ["--ds", "synthetic", "--seg_dir", sd, "--ae_dir", ad,
                 "--output", os.path.join(out_dir, f"reg_{name}")] + extra))
            after = _counts(ks, knn_cuda)
            launched = {k: after[k] - before[k] for k in after
                        if after[k] > before[k]}
            if min(m["reconstructed"]) < 1 or not m["chamfers"] or not \
                    np.isfinite(m["chamfers"]).all():
                raise AssertionError(f"dseg {name}: reconstructed per case "
                                     f"{m['reconstructed']}, chamfers "
                                     f"{m['chamfers']}")
            for k in ("knn", "gather_reduce") + (
                    ("fps",) if name != "accumulate" else ()):
                if launched.get(k, 0) < 1:
                    raise AssertionError(f"dseg {name}: {k} never launched")
            runs[name] = {"chamfer": m["chamfer"], "chamfers": m["chamfers"],
                          "reconstructed": m["reconstructed"],
                          "s_per_case": m["times"],
                          "mean_s_per_case": float(np.mean(m["times"])),
                          "launches": launched}
            print(f"dseg {name}: chamfer {m['chamfer']:.5f}, reconstructed "
                  f"fissures per case {m['reconstructed']}, s/case "
                  f"{['%.4f' % t for t in m['times']]}, launches {launched}"
                  f" on {card}", flush=True)
    a, b = runs["farthest"]["chamfers"], runs["farthest_fst"]["chamfers"]
    if len(a) != len(b) or not np.allclose(a, b, rtol=1e-5, atol=0):
        raise AssertionError(f"dseg: .fst folds give {b}, model.pt {a}")
    timing.update(runs=runs, fst_equal_bits=a == b)
    return (_counts(ks, knn_cuda), timing, _gr_calls(ks, knn_cuda),
            _slice_calls(ks, knn_cuda))


def phase_dseg_reference(card: str, seg_dir: str, ae_dir: str):
    """DSEG-AE on one synthetic case (8000 points, seed 7), card against
    CPU with the same injected draws (10 ensemble subsets, per class the
    padding's and the accumulation's uniforms and normals). The seg fold is
    bf16 and dynamic, whose feature graphs round differently on the two
    devices: at least DSEG_TOL["label_share"] of the labels agree. Then
    both reconstruct from the CPU's labels: K1's padding graph and K5's
    masked selections are exact, so the padded points agree within
    DSEG_TOL["padded"]. The AE's feature graphs (layers 1-3, f32) are
    built from features whose products round differently on the two
    devices, and a near-tie swapped there moves a latent code by a step
    (a first reading: codes 2.9e-4 apart at their largest entry, where
    another card run's were 6e-7): in every graph at least
    DSEG_TOL["graph_share"] of the neighbour sets agree (readings, the
    least graph of each mode: 0.996 of 9 graphs farthest, 0.986 of 90
    accumulate; a wrong neighbour in every row gives 0), and over all
    classes the decoded vertices
    (farthest and accumulate) and the farthest run's latent codes lie
    within DSEG_TOL["rel_l2"] relative L2 of the CPU's, as phases 21 and
    23 hold gradients. The card's farthest run with every K5 selection
    moved to the next point must move the codes past that limit (the
    codes, since a briefly trained decoder may map different codes to
    nearly the same mesh)."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models import (build_subsets,
                                                       load_fold_model)
    from fissure_segmentation_tpu_torch.models import dseg_ae
    case = make_synthetic_dataset(1, n_points=8000, seed=7)[0]
    pc = torch.as_tensor(np.concatenate([case["coords"], case["features"]],
                                        1))
    n = pc.shape[0]
    g = torch.Generator().manual_seed(25)
    subsets = build_subsets(n, 2048, 10, g)
    draws = [{"extend": (torch.rand((1, n), generator=g),
                         torch.randn((1, n, 3), generator=g),
                         torch.randn((1, n, 1), generator=g)),
              "accumulate": [torch.rand((1, n), generator=g)
                             for _ in range(dseg_ae.N_ACCUMULATE)]}
             for _ in range(3)]
    seg0 = load_fold_model(os.path.join(seg_dir, "fold0"))
    ae0 = load_fold_model(os.path.join(ae_dir, "fold0"))
    models = {dev: {mode: dseg_ae.RegularizedSegDGCNN(
        copy.deepcopy(seg0).to(dev), copy.deepcopy(ae0).to(dev), 2048, 1024,
        mode, random_extend=True) for mode in ("farthest", "accumulate")}
        for dev in ("cuda", "cpu")}
    labels = {dev: models[dev]["farthest"].segment(pc.to(dev),
                                                   subsets=subsets).cpu()
              for dev in ("cuda", "cpu")}
    share = float((labels["cuda"] == labels["cpu"]).float().mean())
    lab = labels["cpu"]
    sizes = np.bincount(lab.numpy(), minlength=4)[1:]
    if not (sizes >= 20).any():
        raise AssertionError(f"dseg reference: class sizes {sizes}")
    obj = 1 + int(np.argmin(np.where(sizes >= 20, sizes, n + 1)))
    mask = (lab == obj)[None]
    padded = [dseg_ae.random_extend_points(
        pc[None, :, :3].contiguous().to(dev), mask.to(dev), 1024,
        draws=draws[obj - 1]["extend"])[0].cpu() for dev in ("cuda", "cpu")]
    pad_gap = float((padded[0] - padded[1]).abs().max())

    def gap(a, b, part):
        """Relative L2 over the classes of the vertices (part 0) or, with
        return_hidden, the latent codes (part 1)."""
        def pick(o):
            return o[0][0] if part == 0 and isinstance(o[0], tuple) \
                else o[part]
        pairs = [(pick(x).cpu(), pick(y)) for x, y in zip(a, b)
                 if y is not None]
        if [x is None for x in a] != [y is None for y in b] or not pairs:
            raise AssertionError("dseg reference: reconstructed classes "
                                 f"differ or none: {sizes}")
        return float(torch.sqrt(sum(((x - y) ** 2).sum() for x, y in pairs)
                                / sum((y ** 2).sum() for _, y in pairs)))
    out = {"label_share": share, "class_sizes": sizes.tolist(),
           "padded_class": obj, "padded_gap": pad_gap}
    for mode in ("farthest", "accumulate"):
        res, recs = {}, {}
        for dev in ("cuda", "cpu"):
            with GraphRecorder() as recs[dev]:
                res[dev] = models[dev][mode].reconstruct(
                    pc.to(dev), lab.to(dev), return_hidden=True,
                    draws=draws)
        out[f"{mode}_graph_share"] = min(_same_sets(x, y) for x, y in zip(
            recs["cuda"].graphs, recs["cpu"].graphs))
        out[f"{mode}_verts"] = gap(res["cuda"], res["cpu"], 0)
        if mode == "farthest":
            res_c = res["cpu"]
            out["farthest_codes"] = gap(res["cuda"], res_c, 1)
    real = dseg_ae.farthest_point_sampling
    dseg_ae.farthest_point_sampling = lambda p, m, mask=None: (
        real(p, m, mask=mask) + 1) % p.shape[1]
    try:
        res_f = models["cuda"]["farthest"].reconstruct(
            pc.cuda(), lab.cuda(), return_hidden=True, draws=draws)
    finally:
        dseg_ae.farthest_point_sampling = real
    out["planted_fault_codes"] = gap(res_f, res_c, 1)
    if (share < DSEG_TOL["label_share"]
            or not pad_gap <= DSEG_TOL["padded"]
            or min(out["farthest_graph_share"],
                   out["accumulate_graph_share"]) < DSEG_TOL["graph_share"]
            or max(out["farthest_verts"], out["farthest_codes"],
                   out["accumulate_verts"]) > DSEG_TOL["rel_l2"]):
        raise AssertionError(f"dseg reference: {out} against {DSEG_TOL}")
    if out["planted_fault_codes"] <= DSEG_TOL["rel_l2"]:
        raise AssertionError("dseg reference: shifted FPS selections moved"
                             f" the codes only {out['planted_fault_codes']}")
    print(f"dseg reference: card vs CPU {out} (limits {DSEG_TOL}) on {card}",
          flush=True)
    return out


# ---- the CNN's training half: K6's backward, train_seg_cnn -----------------

CNN_ARGV = ["--ds", "synthetic", "--fold", "0"]   # patch 96, 1.5 mm, batch 32
# K6's layers in a train step at the defaults (32 patches of 96^3), by
# name: (x's shape, stride, launches of each role a v1 step; v3's timed
# once)
WG_PATH = {
    "v1_b0_32x48x48x48x32": ((32, 48, 48, 48, 32), 1, 1),
    "v1_b1_32x48x48x48x96": ((32, 48, 48, 48, 96), 1, 1),
    "v1_b2b3_32x48x48x48x144": ((32, 48, 48, 48, 144), 1, 2),
    "v1_b4_32x48x48x48x192": ((32, 48, 48, 48, 192), 1, 1),
    "v1_b5_s2_32x48x48x48x192": ((32, 48, 48, 48, 192), 2, 1),
    "v1_b6_32x24x24x24x192": ((32, 24, 24, 24, 192), 1, 1),
    "v1_b7_32x24x24x24x384": ((32, 24, 24, 24, 384), 1, 1),
    "v3_r0_32x48x48x48x16": ((32, 48, 48, 48, 16), 1, 0),
    "v3_r1_s2_32x48x48x48x64": ((32, 48, 48, 48, 64), 2, 0),
    "v3_r2_32x24x24x24x72": ((32, 24, 24, 24, 72), 1, 0),
    "v3_r6_s2_32x12x12x12x240": ((32, 12, 12, 12, 240), 2, 0),
    "v3_r7_32x6x6x6x200": ((32, 6, 6, 6, 200), 1, 0),
    "v3_r11_32x6x6x6x672": ((32, 6, 6, 6, 672), 1, 0),
}
# K6's backward layers a step (each one dgrad and one wgrad launch): v1's
# seven stride-1 layers and block 5; v3's rows 0, 2, 7-11 and rows 1, 6
K6_LAYERS = {"v1": (7, 1), "v3": (7, 2)}
# the wgrad kernel's hard cases, at both strides: C below, off and across
# the 32-channel groups (C off 4: the simple kernel), D = 1, one voxel
# along W, odd D, H, W, rows not a multiple of the thread rows, H and W
# off the tiles
WG_HARD = {"c8_2x5x6x7x8": (2, 5, 6, 7, 8), "c33_1x3x9x11x33": (1, 3, 9, 11, 33),
           "c144_2x7x5x40x144": (2, 7, 5, 40, 144),
           "d1_1x1x4x4x5": (1, 1, 4, 4, 5), "w1_3x2x3x1x64": (3, 2, 3, 1, 64),
           "odd_1x9x13x21x36": (1, 9, 13, 21, 36),
           "d2_2x2x17x9x96": (2, 2, 17, 9, 96)}
CNN_STEP_TOL = {"loss": 1e-4, "grad_rel_l2": 3e-2, "stats": 1e-3,
                "param": 2e-4}


def wgrad_bound(x, gy, stride=1):
    """(float64 plain wgrad, the kernel's rounding bound gamma_depth *
    sum |x gy| per tap and channel, depth)."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_wgrad_plain, gamma, wgrad_plan)
    want = depthwise_conv3_wgrad_plain(x.double(), gy.double(), stride)
    absw = depthwise_conv3_wgrad_plain(x.double().abs(), gy.double().abs(),
                                       stride)
    depth = wgrad_plan(tuple(x.shape), stride).depth
    return want, gamma(depth) * absw, depth


def over_bound(err, bound) -> float:
    """max err / bound; a tap whose bound is 0 (every term padding) must
    be exact."""
    inf = torch.full_like(err, float("inf"))
    return torch.where(bound > 0, err / bound,
                       torch.where(err > 0, inf, 0 * err)).max().item()


def planted_wgrad(x, gy, wgrad=None, stride=1):
    """The wgrad kernel's (`wgrad`'s) dw with one tap (the centre) taken
    from x moved by one voxel along W: a fault the bound must see."""
    if wgrad is None:
        from fissure_segmentation_tpu_torch.kernels.depthwise import \
            depthwise_conv3_wgrad_cuda as wgrad
    dw = wgrad(x, gy, stride).clone()
    dw[1, 1, 1] = wgrad(torch.roll(x, 1, dims=3).contiguous(), gy,
                        stride)[1, 1, 1]
    return dw


def phase_wgrad():
    """K6's backward on the card at strides 1 and 2: the wgrad kernel
    against the float64 plain version within gamma_depth * sum |x dy|
    (depth from its launch plan) and equal from launch to launch, the
    dgrad (K6 with flipped taps; at stride 2 on dy stuffed to x's shape)
    equal to the plain version, at every K6 layer of train_seg_cnn's step
    (v1 and v3 at the defaults) and at the wgrad kernel's hard cases at
    both strides; the planted fault (one tap one voxel off) must miss the
    bound. Median times of the wgrad kernel, its plain version, cuDNN's
    conv3d_weight (the library call) and the bound; of the dgrad (at
    stride 2 with its stuffing, also timed alone), its plain version and
    cuDNN's conv3d_input. Returns (max |wgrad - float64|, max err / bound,
    timings, sums over one v1 step)."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_dgrad, depthwise_conv3_plain,
        depthwise_conv3_wgrad_cuda, depthwise_conv3_wgrad_plain, out_shape,
        stuff)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    max_err, max_ratio, timings = 0.0, 0.0, {}
    step = {k: 0.0 for k in ("wgrad_ms", "wgrad_plain_ms", "wgrad_bound_ms",
                             "wgrad_library_ms", "dgrad_ms", "dgrad_plain_ms",
                             "dgrad_bound_ms", "dgrad_library_ms")}
    step["launches"] = 0
    cases = {**WG_PATH,
             **{f"{k}_s{s}": (v, s, 0) for k, v in WG_HARD.items()
                for s in (1, 2)}}
    for name, (shape, s, per_step) in cases.items():
        c = shape[-1]
        x = torch.randn(shape, generator=g, device=dev)
        gy = torch.randn(out_shape(shape, s), generator=g, device=dev)
        w = torch.randn((3, 3, 3, c), generator=g, device=dev)
        got = depthwise_conv3_wgrad_cuda(x, gy, s)
        torch.cuda.synchronize()
        want, bound, depth = wgrad_bound(x, gy, s)
        err = (got.double() - want).abs()
        ratio = over_bound(err, bound)
        max_err, max_ratio = max(max_err, err.max().item()), max(max_ratio,
                                                                 ratio)
        if not ratio <= 1:
            raise AssertionError(f"wgrad {name}: {ratio:.3g} x its bound "
                                 f"gamma_{depth} sum|x dy|")
        if not torch.equal(depthwise_conv3_wgrad_cuda(x, gy, s), got):
            raise AssertionError(f"wgrad {name}: two launches differ")
        # (with W = 1 the voxel one off along W is the voxel itself)
        planted = over_bound((planted_wgrad(x, gy, stride=s).double()
                              - want).abs(), bound) \
            if shape[3] > 1 else float("inf")
        if planted <= 1:
            raise AssertionError(f"wgrad {name}: the planted fault stays "
                                 f"within the bound ({planted:.3g})")
        wf = w.flip((0, 1, 2)).contiguous()
        dx = depthwise_conv3_dgrad(gy, w, s, x.shape)
        torch.cuda.synchronize()
        want_dx = depthwise_conv3_plain(stuff(gy, x.shape) if s == 2 else gy,
                                        wf)
        if dx.shape != x.shape or not torch.equal(dx, want_dx):
            raise AssertionError(f"dgrad {name}: kernel differs from plain")
        line = (f"K6 backward {name}: wgrad within {ratio:.3g} of its bound "
                f"(depth {depth}, max err {err.max().item():.3g}; the "
                f"planted fault {planted:.3g} x), dgrad == plain")
        if shape[0] == 32:
            n, m = x.numel(), gy.numel()
            xc, gc = x.permute(0, 4, 1, 2, 3), gy.permute(0, 4, 1, 2, 3)
            wshape = (c, 1, 3, 3, 3)
            t = {"wgrad_ms": median_ms(lambda: depthwise_conv3_wgrad_cuda(
                     x, gy, s), reps=5, inner=3),
                 "wgrad_plain_ms": median_ms(
                     lambda: depthwise_conv3_wgrad_plain(x, gy, s), reps=3,
                     inner=1, warm=1),
                 "wgrad_library_ms": median_ms(
                     lambda: torch.nn.grad.conv3d_weight(
                         xc, wshape, gc, stride=s, padding=1, groups=c),
                     reps=3, inner=1, warm=1),
                 "dgrad_ms": median_ms(
                     lambda: depthwise_conv3_dgrad(gy, w, s, x.shape),
                     reps=5, inner=3),
                 "dgrad_plain_ms": median_ms(
                     lambda: depthwise_conv3_plain(
                         stuff(gy, x.shape) if s == 2 else gy, wf),
                     reps=3, inner=1, warm=1),
                 "dgrad_library_ms": median_ms(
                     lambda: torch.nn.grad.conv3d_input(
                         xc.shape, w.permute(3, 0, 1, 2).unsqueeze(1), gc,
                         stride=s, padding=1, groups=c), reps=3, inner=1,
                     warm=1)}
            if s == 2:   # the dgrad's stuffing alone: one write at x's size
                t["stuff_ms"] = median_ms(lambda: stuff(gy, x.shape),
                                          reps=5, inner=3)
            # wgrad reads x and dy once and writes 27 C; dgrad reads dy and
            # w once and writes dx; 27 multiply-adds for each of dy's values
            t["wgrad_bound_ms"], t["wgrad_bound_by"] = bound_ms(
                (n + m + 27 * c) * 4, 54 * m)
            t["dgrad_bound_ms"], t["dgrad_bound_by"] = bound_ms(
                (n + m + 27 * c) * 4, 54 * m)
            t.update(stride=s, max_abs_err=err.max().item(),
                     err_over_bound=ratio, depth=depth,
                     launches_per_v1_step=per_step)
            timings[name] = t
            for k in step:
                if k != "launches":
                    step[k] += per_step * t[k]
            step["launches"] += per_step
            line += (f"; wgrad {t['wgrad_ms']:.4f} ms, plain "
                     f"{t['wgrad_plain_ms']:.4f}, conv3d_weight "
                     f"{t['wgrad_library_ms']:.4f}, bound "
                     f"{t['wgrad_bound_ms']:.4f} ({t['wgrad_bound_by']}); "
                     f"dgrad {t['dgrad_ms']:.4f} ms"
                     + (f" (stuffing {t['stuff_ms']:.4f})" if s == 2 else "")
                     + f", plain {t['dgrad_plain_ms']:.4f}, conv3d_input "
                     f"{t['dgrad_library_ms']:.4f}")
        print(line, flush=True)
        del x, gy, w, got, want, bound, dx, want_dx
        torch.cuda.empty_cache()
    print(f"K6 backward, one v1 step ({step['launches']} launches each): "
          f"wgrad {step['wgrad_ms']:.3f} ms (bound "
          f"{step['wgrad_bound_ms']:.3f}, conv3d_weight "
          f"{step['wgrad_library_ms']:.3f}); dgrad {step['dgrad_ms']:.3f} ms "
          f"(conv3d_input {step['dgrad_library_ms']:.3f})", flush=True)
    return max_err, max_ratio, timings, step


def _check_cnn_run(out: str, model_cls, what: str) -> dict:
    """The JAX entry's files of a train_seg_cnn run, finite Dice in
    [0, 1], the fold's model.fst of `model_cls`."""
    from fissure_segmentation_tpu_torch.models import load_fold_model
    for f in ("op_count.csv", "cross_val_split.json", "commandline_args.json",
              "cv_results.csv", "fold0/train_time.csv", "fold0/model.fst",
              "fold0/test/test_dice.csv"):
        if not os.path.exists(os.path.join(out, f)):
            raise AssertionError(f"{what}: no {f}")
    rows = _csv(os.path.join(out, "fold0", "test", "test_dice.csv"))
    dice = [float(v) for v in rows[1]]
    if rows[0] != [f"class{i}" for i in range(len(dice))] or \
            not all(0 <= d <= 1 for d in dice):
        raise AssertionError(f"{what}: test_dice.csv {rows}")
    ops = _csv(os.path.join(out, "op_count.csv"))
    model = load_fold_model(os.path.join(out, "fold0"))
    if ops[0] != ["flops", "bytes_accessed", "params"] or \
            int(ops[1][2]) != sum(p.numel() for p in model.parameters()) \
            or not isinstance(model, model_cls):
        raise AssertionError(f"{what}: op_count.csv {ops}, model "
                             f"{type(model).__name__}")
    cv = _csv(os.path.join(out, "cv_results.csv"))
    return {"dice": dice, "cv": cv[1], "op_count": ops[1]}


def phase_cnn_train(ks, knn_cuda, card: str, out_dir: str):
    """The train_seg_cnn entry at full width (its defaults: 32 patches of
    96^3 at 1.5 mm, nnunet, f32, the 8 synthetic 64^3 cases): v1 trains
    fold 0 for 2 epochs and tests it, then --test_only on the same output;
    v3 trains 1 epoch and tests it (each run: the JAX entry's files,
    finite Dice, the launches of K6 by role and of its wgrad, counts reset
    before and read after each run; every step of the backward: one dgrad
    and one wgrad launch a K6 layer, K6_LAYERS: v1 7 at stride 1 and 1 at
    stride 2, v3 7 and 2). Then the test half of v1's fold again, warm
    (s/case), and 10 timed warm steps of each
    (train_seg_cnn.make_step: ms/step, patches/s, peak memory) and a
    profile of 3 (device time by kind, profile_step.cnn_device_time); then
    one step's conv3d calls by groups and kernel size: v1 must make no
    grouped call (its one grouped layer, block 5, runs on K6), v3 only its
    5x5x5 layers' (rows 1 and 6 run on K6).
    Returns (launches by path, timing)."""
    from fissure_segmentation_tpu_torch import train_seg_cnn
    from fissure_segmentation_tpu_torch.cli import get_seg_cnn_train_parser
    from fissure_segmentation_tpu_torch.data.dataset import load_split_file
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_cuda, depthwise_conv3_wgrad_cuda)
    from fissure_segmentation_tpu_torch.models import (LRASPPMobileNetV33D,
                                                       MobileNetASPP,
                                                       load_fold_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, cnn_device_time, time_steps)
    from torch.profiler import ProfilerActivity, profile
    paths, timing = {}, {}
    runs = (("v1", 2, MobileNetASPP, []), ("v1_test_only", 0, MobileNetASPP,
                                           ["--test_only"]),
            ("v3", 1, LRASPPMobileNetV33D, []))
    for name, epochs, cls, extra in runs:
        out = os.path.join(out_dir, f"cnn_{name[:2]}")
        argv = CNN_ARGV + ["--model", name[:2], "--output", out] + extra
        if epochs:
            argv += ["--epochs", str(epochs)]
        _reset(ks, knn_cuda)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if train_seg_cnn.main(argv) != 0:
            raise AssertionError(f"train_seg_cnn {name}: failed")
        took = time.perf_counter() - t0
        res = _check_cnn_run(out, cls, f"train_seg_cnn {name}")
        launches = {**depthwise_conv3_cuda.roles,
                    "wgrad": depthwise_conv3_wgrad_cuda.launches,
                    "wgrad_stride2":
                        depthwise_conv3_wgrad_cuda.roles["stride2"]}
        ones, twos = K6_LAYERS[name[:2]]
        back, steps = launches["dgrad"], launches["dgrad"] // (ones + twos)
        if launches["forward"] < ones or launches["stride2"] < twos or \
                back != launches["wgrad"] or back % (ones + twos) or \
                launches["wgrad_stride2"] != twos * steps or \
                steps < epochs or (back and not epochs):
            raise AssertionError(f"train_seg_cnn {name}: K6 launches "
                                 f"{launches} in {epochs} epochs")
        paths[f"train_seg_cnn_{name}"] = launches
        timing[name] = {"s": took, "peak_bytes":
                        torch.cuda.max_memory_allocated(), **res}
        print(f"train_seg_cnn {name}: {epochs} epoch(s) of fold 0 and the "
              f"test in {took:.1f} s, test Dice {res['dice']}, peak "
              f"{timing[name]['peak_bytes'] / 2 ** 30:.2f} GiB, launches "
              f"{launches} on {card}", flush=True)
    parser = get_seg_cnn_train_parser()
    # the test half alone: v1's fold 0 on its validation cases, warm
    out = os.path.join(out_dir, "cnn_v1")
    args = parser.parse_args(CNN_ARGV + ["--model", "v1"])
    _, val = train_seg_cnn.build_dataset(args).split_data_set(
        load_split_file(os.path.join(out, "cross_val_split.json"))[0])
    model = load_fold_model(os.path.join(out, "fold0"))
    test_dir = os.path.join(out_dir, "test_again")
    train_seg_cnn.test_cnn(val, model, test_dir, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_seg_cnn.test_cnn(val, model, test_dir, "cuda")
    torch.cuda.synchronize()
    timing["v1_test_s_per_case"] = (time.perf_counter() - t0) / len(val)
    print(f"train_seg_cnn v1 test half: "
          f"{timing['v1_test_s_per_case']:.4f} s/case over {len(val)} "
          f"cases of {val[0][0].shape} (warm) on {card}", flush=True)
    for name in ("v1", "v3"):
        args = parser.parse_args(CNN_ARGV + ["--model", name])
        step = train_seg_cnn.make_step(args, out_dir, "cuda")
        for _ in range(WARM):
            step()
        ms, peak, losses = time_steps(step)
        if not torch.isfinite(torch.stack(losses)).all():
            raise AssertionError(f"cnn {name} step: non-finite loss")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        avg = prof.key_averages()
        kinds = cnn_device_time(avg, 3)
        top = sorted(((e.self_device_time_total / 3e3, e.key)
                      for e in device_rows(avg)
                      if e.self_device_time_total > 0), reverse=True)[:12]
        # the convolutions left to cuDNN, by (groups, kernel): one step's
        # F.conv3d calls; the depthwise 3x3x3 layers must all be K6's
        with Conv3dRecorder() as rec:
            step()
            torch.cuda.synchronize()
        left = {k: v for k, v in rec.calls.items() if k[0] > 1}
        if any(k[1] != (5, 5, 5) for k in left) or (name == "v1" and left):
            raise AssertionError(f"cnn {name} step: grouped conv3d calls "
                                 f"{left}: the 3x3x3 depthwise layers must "
                                 f"run on K6")
        timing[f"{name}_step"] = {
            "conv3d_calls": {f"groups{g}_k{k[0]}": n
                             for (g, k), n in sorted(rec.calls.items())},
            # cuDNN's names: a groups = 1 layer may run a "grouped" kernel
            "grouped_named_kernels": sorted(
                {e.key[:90] for e in device_rows(avg)
                 if "grouped" in e.key.lower()}),
            "ms_per_step": ms, "patches_per_s": args.batch * 1e3 / ms,
            "peak_bytes": peak, "device_ms_by_kind": kinds,
            "busy_share": kinds["total"] / ms,
            "top_kernels_ms": [[round(t, 4), k[:90]] for t, k in top]}
        print(f"cnn {name} step: {ms:.2f} ms/step ({args.batch * 1e3 / ms:.2f} "
              f"patches/s), peak {peak / 2 ** 30:.2f} GiB; device ms a step "
              f"by kind {kinds} (busy {kinds['total'] / ms:.3f}) on {card}",
              flush=True)
        print(avg.table(sort_by="self_device_time_total", row_limit=16,
                        max_name_column_width=70), flush=True)
        del step
        torch.cuda.empty_cache()
    return paths, timing


def _cnn_step_state(trainer) -> dict:
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    out = dict(_leaves(export_jax_variables(trainer.model)))
    out.update({f"grad/{k}": v for k, v in _leaves(
        export_jax_variables(trainer.model, grad=True))})
    return out


def phase_cnn_train_reference(card: str):
    """One train step of each CNN at full width on a small batch (2
    patches of 32^3 with augmentation), card (K6 and its backward, cuDNN,
    TF32 off) against CPU (plain versions) from the same weights, crops,
    augmentation draws and dropout mask: the loss within 1e-4 relative,
    the whole gradient within 3e-2 relative L2 (train-mode BatchNorm over
    few voxels amplifies summation-order rounding; tests/test_torch_cnn_
    train.py reads 7.8e-3 against JAX), running statistics within 1e-3,
    each parameter within 2e-4 of the move Adam's first step makes from
    each side's gradient. The v1 step again with the planted wgrad fault
    (the centre tap from x one voxel off) must miss the gradient
    tolerance on the K6 layers' kernels."""
    from fissure_segmentation_tpu_torch.data.image_dataset import (
        ImageDataset, draw_augmentation)
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.kernels import depthwise
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.models import (LRASPPMobileNetV33D,
                                                       MobileNetASPP)
    from fissure_segmentation_tpu_torch.train.image_trainer import \
        ImageTrainer
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    cases = [make_synthetic_image_case(i, shape=(40, 40, 40))
             for i in range(2)]
    ds = ImageDataset([c["image"] * 3 for c in cases],
                      [c["labels"] for c in cases],
                      [(c["case_id"], c["sequence"]) for c in cases],
                      patch_size=(32, 32, 32), preprocessed=True)
    weights = torch.as_tensor(ds.get_class_weights(), dtype=torch.float32)
    imgs, lbls = ds.crop_batch(np.random.default_rng(0), [0, 1])
    draws = draw_augmentation(torch.Generator().manual_seed(1), imgs.shape)
    out = {}
    for name, cls in (("v1", MobileNetASPP), ("v3", LRASPPMobileNetV33D)):
        model0 = cls(num_classes=ds.num_classes, patch_size=(32,) * 3,
                     generator=torch.Generator().manual_seed(2))
        keep = (torch.rand((2, 8, 8, 8, 128), generator=torch.Generator()
                           .manual_seed(3)) < 0.5) if name == "v1" else None
        states = {}

        def run(dev, model0=model0, keep=keep):
            trainer = ImageTrainer(
                copy.deepcopy(model0), ds,
                get_loss_fn("nnunet", weights.to(dev)), tempfile.mkdtemp(),
                TrainConfig(batch_size=2, seed=0), device=dev)
            loss, _ = trainer.train_step(
                imgs.to(dev), lbls.to(dev),
                draws={k: v.to(dev) for k, v in draws.items()},
                keep=None if keep is None else keep.to(dev))
            return float(loss), _cnn_step_state(trainer)
        for dev in ("cpu", "cuda"):
            states[dev] = run(dev)
        res = _cnn_step_compare(states["cuda"], states["cpu"],
                                _leaves_of(model0))
        if name == "v1":
            good = depthwise.depthwise_conv3_wgrad_cuda

            def faulty_wgrad(x, gy, stride=1):
                return planted_wgrad(x, gy, good, stride)
            # the wrapper counts under its name
            faulty_wgrad.launches = 0
            faulty_wgrad.roles = dict.fromkeys(good.roles, 0)
            depthwise.depthwise_conv3_wgrad_cuda = faulty_wgrad
            try:
                faulty = run("cuda")
            finally:
                depthwise.depthwise_conv3_wgrad_cuda = good
            res["planted_k6_grad_rel_l2"] = _k6_grad_rel(faulty[1],
                                                         states["cpu"][1])
            res["k6_grad_rel_l2"] = _k6_grad_rel(states["cuda"][1],
                                                 states["cpu"][1])
            if res["planted_k6_grad_rel_l2"] <= CNN_STEP_TOL["grad_rel_l2"]:
                raise AssertionError(f"cnn reference: the planted wgrad "
                                     f"fault is missed ({res})")
        out[name] = res
        print(f"cnn train reference {name}: card vs CPU {res} (limits "
              f"{CNN_STEP_TOL}) on {card}", flush=True)
    return out


def _leaves_of(model) -> dict:
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    return dict(_leaves(export_jax_variables(model)))


def _k6_grad_rel(got: dict, want: dict) -> float:
    """The largest relative L2 difference of a K6 layer's kernel gradient
    (the leaves of shape (3, 3, 3, 1, C))."""
    keys = [k for k in want if k.startswith("grad/")
            and want[k].ndim == 5 and want[k].shape[:4] == (3, 3, 3, 1)]
    return max(float(np.linalg.norm(got[k] - want[k])
                     / np.linalg.norm(want[k])) for k in keys)


def _cnn_step_compare(card, cpu, init) -> dict:
    (loss_g, got), (loss_w, want) = card, cpu
    res = {"loss_rel": abs(loss_g - loss_w) / abs(loss_w)}
    grads = [k for k in want if k.startswith("grad/")]
    res["grad_rel_l2"] = float(np.sqrt(
        sum(((got[k] - want[k]).astype(np.float64) ** 2).sum() for k in grads)
        / sum((want[k].astype(np.float64) ** 2).sum() for k in grads)))
    res["stats_max_abs"] = max(float(np.abs(got[k] - want[k]).max())
                               for k in want if k.startswith("batch_stats"))
    excess = 0.0
    for k in want:
        if not k.startswith("params/"):
            continue
        g = {d: v["grad/" + k] + 1e-5 * init[k] for d, v in
             (("card", got), ("cpu", want))}
        moves = [1e-3 * v / (np.abs(v) + 1e-8) for v in g.values()]
        allowed = np.abs(moves[0] - moves[1]) + CNN_STEP_TOL["param"]
        excess = max(excess, float((np.abs(got[k] - want[k]) - allowed)
                                   .max()))
    res["param_excess"] = excess
    if not (res["loss_rel"] <= CNN_STEP_TOL["loss"]
            and res["grad_rel_l2"] <= CNN_STEP_TOL["grad_rel_l2"]
            and res["stats_max_abs"] <= CNN_STEP_TOL["stats"]
            and excess <= 0):
        raise AssertionError(f"cnn reference: card vs CPU {res}")
    return res


# ---- DPSR-Net and DG-SSM (phases 29-32) -------------------------------------

# the JAX entries' defaults (DGCNN k = 20, dynamic, f32, batch 32, 1024
# points; DPSR-Net: a 128^3 grid, sigma 10, v2; DG-SSM: alpha 3, target
# variance 0.95), cut in epochs only
DPSR_ARGV = ["--ds", "synthetic", "--fold", "0"]
DGSSM_ARGV = ["--ds", "synthetic", "--fold", "0", "--epochs", "3",
              "--predict_affine"]
DPSR_STAGES = ("dpsr:seg_net", "dpsr:splat_normals", "dpsr:psr",
               "dpsr:marching_sampling")
# phase_dpsr_reference says why
DPSR_TOL = {"logits": 1e-4, "psr": 1e-4, "samples_share": 0.99,
            "samples_rel_l2": 0.05, "grad_rel_l2": 1e-2,
            "chamfer_grad_rel_l2": 1e-2}
DGSSM_TOL = {"outputs": 1e-4, "loss": 1e-4, "grad_rel_l2": 1e-3}


def _dpsr_step_split(step, steps: int = 3) -> dict:
    """Device ms a step of a DPSR-Net step by stage, from torch.profiler
    over `steps` warm steps: the forward's four ranges (models/
    dpsr_net.py), and the rest of the step's kernels (the loss, the
    backward and Adam) as "backward"; "total" is every kernel's time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    total = sum(e.self_device_time_total
                for e in device_rows(avg)) / steps / 1e3
    out = {name.split(":")[1]: sum(e.self_device_time_total for e in avg
                                   if e.key == name) / steps / 1e3
           for name in DPSR_STAGES}
    out["backward"] = total - sum(out.values())
    out["total"] = total
    return out


def _check_history(path: str, epochs: int, what: str) -> dict:
    rows = list(csv.DictReader(open(path)))
    hist = {k: [float(r[k]) for r in rows] for k in rows[0]}
    if len(rows) != epochs or not all(np.isfinite(v).all()
                                      for v in hist.values()):
        raise AssertionError(f"{what}: history {hist}")
    return hist


def phase_dpsr(ks, knn_cuda, card: str, out_dir: str):
    """DPSR-Net at the JAX entry's full width (DPSR_ARGV, v2: 3 epochs of
    fold 0 and its test, so the Chamfer term is on from epoch 1): finite
    losses, the Chamfer component 0 in epoch 0 and above 0 after,
    model.pt (a DPSRNet2 at 128^3), op_count.csv, the test half's files
    with finite Dice (its s/case); then 10 timed warm steps with the
    Chamfer term on (ms/step, clouds/s, peak memory, launches: K1, the
    transpose, K2, K3, K4 from the transpose, the gather-reduce, each
    every step) and the device ms a step by stage (_dpsr_step_split). Then
    v1 (--dpsr_version 1) at the same width: 1 epoch, then 3 timed steps
    (K1 twice a step: the coordinate graph and the normals of the B x 3
    class clouds). Counts are reset before and read after; returns
    (counts, timing, calls by kernel, gather-reduce calls, K4 calls)."""
    from fissure_segmentation_tpu_torch import train_dpsr_net
    from fissure_segmentation_tpu_torch.cli import get_dpsr_train_parser
    from fissure_segmentation_tpu_torch.models import (DPSRNet, DPSRNet2,
                                                       load_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, time_steps)
    parser = get_dpsr_train_parser()
    timing = {}
    _reset(ks, knn_cuda)
    for version, epochs, extra in ((2, 3, []),
                                   (1, 1, ["--dpsr_version", "1",
                                           "--train_only"])):
        out = os.path.join(out_dir, f"dpsr_v{version}")
        argv = DPSR_ARGV + ["--epochs", str(epochs), "--output", out] + extra
        t0 = time.perf_counter()
        if train_dpsr_net.main(argv) != 0:
            raise AssertionError(f"dpsr v{version}: the entry failed")
        took = time.perf_counter() - t0
        hist = _check_history(os.path.join(out, "fold0", "history.csv"),
                              epochs, f"dpsr v{version}")
        cham = hist["train_Chamfer"]
        if cham[0] != 0.0 or not all(v > 0 for v in cham[1:]):
            raise AssertionError(f"dpsr v{version}: Chamfer history {cham}")
        model = load_model(os.path.join(out, "fold0", "model.pt"))
        want = DPSRNet2 if version == 2 else DPSRNet
        if type(model) is not want or model.config["dpsr_res"] != [128] * 3 \
                or model.config["k"] != 20 or not model.config["dynamic"]:
            raise AssertionError(f"dpsr v{version}: model.pt holds "
                                 f"{type(model).__name__} {model.config}")
        ops = _csv(os.path.join(out, "op_count.csv"))
        if ops[0] != ["flops", "bytes_accessed", "params"] or \
                not float(ops[1][2]) > 0:
            raise AssertionError(f"dpsr v{version}: op_count.csv {ops}")
        run = {"train_and_test_s" if version == 2 else "train_s": took,
               "loss_history": hist["train_total_loss"],
               "chamfer_history": cham}
        if version == 2:
            inf, post = _check_test_outputs(os.path.join(out, "fold0",
                                                         "test"), "",
                                            "dpsr")
            run.update(inference_s_per_case=inf, post_s_per_case=post,
                       test_s_per_case=inf + post)
        args = parser.parse_args(argv)
        step = train_dpsr_net.make_step(args, out, "cuda")
        n_steps = STEPS if version == 2 else 3
        for _ in range(WARM if version == 2 else 1):
            step()
        before = _counts(ks, knn_cuda)
        ms, peak, losses = time_steps(step, n_steps)
        after = _counts(ks, knn_cuda)
        if not torch.isfinite(torch.stack(losses)).all():
            raise AssertionError(f"dpsr v{version}: non-finite step loss")
        launched = {k: after[k] - before[k] for k in after}
        need = {"knn": 1 if version == 2 else 2, "transpose": 3,
                "scatter_rows": 1, "scatter_routed": 2, "scatter_count": 2,
                "gather_reduce": 2}
        for k, n in need.items():
            if launched[k] != n * n_steps:
                raise AssertionError(f"dpsr v{version}: {k} launched "
                                     f"{launched[k]} times in {n_steps} "
                                     f"steps, not {n} a step")
        run.update(ms_per_step=ms, clouds_per_s=32e3 / ms,
                   peak_gib=peak / 2 ** 30,
                   launches_per_step={k: v / n_steps
                                      for k, v in launched.items() if v})
        if version == 2:
            run["device_ms_per_step"] = _dpsr_step_split(step)
        timing[f"v{version}"] = run
        print(f"dpsr v{version}: {json.dumps(run)} on {card}", flush=True)
        del step
        torch.cuda.empty_cache()
    k4 = _check_k4_route(ks, "dpsr")
    return (_counts(ks, knn_cuda), timing, _slice_calls(ks, knn_cuda),
            _gr_calls(ks, knn_cuda), k4)


@contextlib.contextmanager
def dpsr_fault(kind: str):
    """A planted fault in the DPSR path while the context lasts: "corner"
    drops the (1, 1, 1) corner of every trilinear splat and interpolation
    (ops/splat.py), "marching_grad" rebuilds the triangles from the
    detached field, cutting the gradient through marching tetrahedra."""
    from fissure_segmentation_tpu_torch.ops import marching, splat
    if kind == "corner":
        mod, name = splat, "_corner_weight"
        real = splat._corner_weight

        def fault(frac, dz, dy, dx):
            w = real(frac, dz, dy, dx)
            return w * 0 if (dz, dy, dx) == (1, 1, 1) else w
    else:
        mod, name = marching, "_gather_triangles"
        real = marching._gather_triangles

        def fault(phi, gids, iso, cy, cx):
            return real(phi.detach(), gids, iso, cy, cx)
    setattr(mod, name, fault)
    try:
        yield
    finally:
        setattr(mod, name, real)


def phase_dpsr_reference(card: str):
    """DPSR-Net v2 card against CPU at a small size (DGCNN k = 8, static,
    2 x 256 dyadic points, a 24^3 grid, sigma 10, 512 samples a class,
    the triangle budget max(2048, 8 r^2)) from one set of weights and the
    same uniforms: one train-mode forward and backward of the DPSR loss
    with its Chamfer term on. Held: the logits and the PSR grids within
    DPSR_TOL of their largest entry (float32 products and cuFFT against
    pocketfft: first card call 1.4e-5 and 5.0e-6), the valid flags equal,
    at least DPSR_TOL["samples_share"] of the samples within 1e-4 of the
    CPU's and all of them within DPSR_TOL["samples_rel_l2"] relative L2 (a
    grid value within rounding of 0 adds or drops a triangle, and a sample
    near that triangle's place in the area CDF moves to a z-order
    neighbour, which may lie across the grid: the card calls read a share
    of 0.998 and 0.021 relative L2), the
    whole gradient and the Chamfer term's gradient within their relative
    L2 limits (the seg net's LeakyReLU branches may split differently
    near 0, as in phase 8). A splat with one corner dropped must miss the
    PSR and sample limits, a marching step without its gradient the
    Chamfer gradient's."""
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.models import DPSRNet2
    g = torch.Generator().manual_seed(31)
    res, s = (24, 24, 24), 512
    model0 = _draw_bn_offsets(DPSRNet2(
        "DGCNN", k=8, in_features=3, num_classes=4, dynamic=False,
        dpsr_res=res, max_tris=max(2048, 8 * 24 * 24), n_surface_samples=s,
        generator=g), 31)
    x = torch.randint(-28, 29, (2, 256, 3), generator=g) / 32.0
    y = torch.randint(0, 4, (2, 256), generator=g)
    surf = torch.rand((6, s, 3), generator=g) * 1.6 - 0.8
    draws = (torch.rand((6, s), generator=g), torch.rand((6, s, 2),
                                                         generator=g))
    cw = torch.tensor([0.5, 1.5, 1.0, 1.0])

    def step(dev):
        m = copy.deepcopy(model0).to(dev).train()
        seg, pts, valid, psr = m(x.to(dev), draws=draws, return_psr=True)
        total, comps = get_loss_fn("dpsr", cw.to(dev))(
            (seg, pts.reshape(6, s, 3), valid.reshape(6, s)),
            (y.to(dev), surf.to(dev), torch.ones((6, s), dtype=torch.bool,
                                                 device=dev)))
        params = [p for _, p in sorted(m.named_parameters())]
        cham = torch.autograd.grad(
            comps["Chamfer"], params, retain_graph=True, allow_unused=True
        ) if comps["Chamfer"].requires_grad else [None] * len(params)
        total.backward()
        return {"seg": seg.detach().cpu().numpy(),
                "psr": psr.detach().cpu().numpy(),
                "pts": pts.detach().cpu().numpy(),
                "valid": valid.cpu().numpy(), "grad": _grads(m),
                "cham": {str(i): (np.zeros(p.shape, np.float32) if c is None
                                  else c.cpu().numpy())
                         for i, (c, p) in enumerate(zip(cham, params))}}

    def compare(got, want):
        return {"logits": float(np.abs(got["seg"] - want["seg"]).max()
                                / np.abs(want["seg"]).max()),
                "psr": float(np.abs(got["psr"] - want["psr"]).max()
                             / np.abs(want["psr"]).max()),
                "valid_equal": bool(np.array_equal(got["valid"],
                                                   want["valid"])),
                "samples_share": float((np.abs(
                    got["pts"] - want["pts"]).max(-1) <= 1e-4).mean()),
                "samples_rel_l2": _rel_l2({"p": got["pts"]},
                                          {"p": want["pts"]}),
                "grad_rel_l2": _rel_l2(got["grad"], want["grad"]),
                "chamfer_grad_rel_l2": _rel_l2(got["cham"], want["cham"])}
    def within(res, k):     # "samples_share" is a least share, the rest
        return (res[k] >= DPSR_TOL[k] if k == "samples_share"   # greatest
                else res[k] <= DPSR_TOL[k])
    cpu = step("cpu")
    out = compare(step("cuda"), cpu)
    if not out["valid_equal"] or not all(within(out, k) for k in DPSR_TOL):
        raise AssertionError(f"dpsr reference: {out} against {DPSR_TOL}")
    faults = {}
    for kind, keys in (("corner", ("psr", "samples_share",
                                   "samples_rel_l2")),
                       ("marching_grad", ("chamfer_grad_rel_l2",))):
        with dpsr_fault(kind):
            f = compare(step("cuda"), cpu)
        faults[kind] = {k: f[k] for k in keys}
        if any(within(f, k) for k in keys):
            raise AssertionError(f"dpsr reference: the planted {kind} "
                                 f"fault gives only {faults[kind]}")
    out["planted_faults"] = faults
    print(f"dpsr reference: card vs CPU {out} (limits {DPSR_TOL}) on "
          f"{card}", flush=True)
    return out


def _time_dpsr_scatter(ks, knn_cuda) -> dict:
    """K3 and K4 at DPSR-Net's train step shape, (32, 1024, k = 20, C =
    64) on its K1 graph, which phase 6 does not time: kernel against
    plain, K3 with its own transpose and with the step's, K4 from the
    transpose's row offsets (its call "ptr_32x1024", also on the card
    alone from CUDA-graph replays) against torch.diff."""
    return _time_scatter_at(ks, knn_cuda, 32, 1024, 20, 64, 29, "dpsr")


def phase_dgssm(ks, knn_cuda, card: str, out_dir: str):
    """DG-SSM at the JAX entry's full width (DGSSM_ARGV: with
    --predict_affine, the default head schedule, the 12 synthetic cases):
    3 epochs of fold 0 and test_dgssm: ssm.npz, model.pt (a DGSSM, every
    head), finite losses, op_count.csv, corr_point_distance.csv and
    cv_results.csv finite; test_dgssm again, timed (s/case); then 10 timed
    warm steps with every head active (ms/step, clouds/s, peak memory,
    launches a step: K1 once, the transpose and K2 4 times each). Counts
    are reset before and read after; returns (counts, timing, calls by
    kernel)."""
    from fissure_segmentation_tpu_torch import train_dgcnn_ssm
    from fissure_segmentation_tpu_torch.cli import get_dgcnn_ssm_train_parser
    from fissure_segmentation_tpu_torch.data.dataset import create_split
    from fissure_segmentation_tpu_torch.models import DGSSM, load_model
    from fissure_segmentation_tpu_torch.shape_model import load_ssm
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, time_steps)
    _reset(ks, knn_cuda)
    out = os.path.join(out_dir, "dgssm")
    argv = DGSSM_ARGV + ["--output", out]
    t0 = time.perf_counter()
    if train_dgcnn_ssm.main(argv) != 0:
        raise AssertionError("dgssm: the entry failed")
    took = time.perf_counter() - t0
    fold = os.path.join(out, "fold0")
    hist = _check_history(os.path.join(fold, "history.csv"), 3, "dgssm")
    model = load_model(os.path.join(fold, "model.pt"))
    ssm = load_ssm(os.path.join(fold, "ssm.npz"))
    if not isinstance(model, DGSSM) or model.ssm_modes != ssm.num_modes \
            or not model.dynamic or model.k != 20:
        raise AssertionError(f"dgssm: model.pt holds {model.config}")
    dist = _csv(os.path.join(fold, "test", "corr_point_distance.csv"))
    cv = _csv(os.path.join(out, "cv_results.csv"))
    if dist[0] != ["mean", "std"] or not np.isfinite(
            np.asarray(dist[1], float)).all() or cv[-1][0] != "mean":
        raise AssertionError(f"dgssm: {dist} {cv}")
    args = get_dgcnn_ssm_train_parser().parse_args(argv)
    ds = train_dgcnn_ssm.build_dataset(args)
    val = ds.split_data_set(create_split([list(i) for i in ds.ids],
                                         k=5)[0])[1]
    t1 = time.perf_counter()
    train_dgcnn_ssm.test_dgssm(val, model, ssm, os.path.join(out, "again"),
                               args.pts, device="cuda")
    test_s = (time.perf_counter() - t1) / len(val)
    step = train_dgcnn_ssm.make_step(args, out, "cuda")
    for _ in range(WARM):
        step()
    before = _counts(ks, knn_cuda)
    ms, peak, losses = time_steps(step)
    after = _counts(ks, knn_cuda)
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError("dgssm: non-finite step loss")
    launched = {k: after[k] - before[k] for k in after}
    for k, n in {"knn": 1, "transpose": 4, "scatter_rows": 4}.items():
        if launched[k] != n * STEPS:
            raise AssertionError(f"dgssm: {k} launched {launched[k]} times "
                                 f"in {STEPS} steps, not {n} a step")
    timing = {"train_and_test_s": took,
              "loss_history": hist["train_total_loss"],
              "ssm_modes": ssm.num_modes,
              "corr_point_distance": float(dist[1][0]),
              "test_s_per_case": test_s, "ms_per_step": ms,
              "clouds_per_s": 32e3 / ms, "peak_gib": peak / 2 ** 30,
              "launches_per_step": {k: v / STEPS
                                    for k, v in launched.items() if v}}
    print(f"dgssm: {json.dumps(timing)} on {card}", flush=True)
    return _counts(ks, knn_cuda), timing, _slice_calls(ks, knn_cuda)


def phase_dgssm_reference(card: str):
    """One DG-SSM train step card against CPU at a small size (k = 8,
    static, 4 clouds of 256 dyadic points at scales 1/4 .. 1, every head
    active and the affine path on, an SSM fitted on 12 random shapes of 64
    points): the outputs within DGSSM_TOL["outputs"] of their largest
    entry, the loss within rtol DGSSM_TOL["loss"], the whole gradient
    within DGSSM_TOL["grad_rel_l2"] relative L2."""
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    from fissure_segmentation_tpu_torch.models import DGSSM
    from fissure_segmentation_tpu_torch.shape_model import (fit_ssm,
                                                            ssm_project)
    rng = np.random.default_rng(32)
    base = rng.normal(0, 0.3, (64, 3))
    ssm = fit_ssm(base + rng.normal(0, 0.05, (12, 64, 3)))
    g = torch.Generator().manual_seed(32)
    model0 = _draw_bn_offsets(DGSSM(k=8, in_features=3,
                                    ssm_modes=ssm.num_modes, dynamic=False,
                                    generator=g), 32)
    scale = torch.tensor([0.25, 0.5, 0.75, 1.0])[:, None, None]
    x = torch.randint(-28, 29, (4, 256, 3), generator=g) / 32.0 * scale
    t_corr = torch.from_numpy(base[None] + rng.normal(
        0, 0.05, (4, 64, 3))).float()
    t_par = torch.cat([torch.randn((4, 6), generator=g) * 0.1,
                       torch.full((4, 3), 0.9)], -1)
    loss_fn = get_loss_fn("ssm")

    def step(dev):
        m = copy.deepcopy(model0).to(dev).train()
        s_ = ssm.to(dev)
        out = m(x.to(dev), s_)
        tc = t_corr.to(dev)
        loss, _ = loss_fn(out, (tc, ssm_project(s_, tc), t_par.to(dev)))
        loss.backward()
        return [o.detach().cpu().numpy() for o in out], float(loss), \
            _grads(m)
    o_g, l_g, g_g = step("cuda")
    o_c, l_c, g_c = step("cpu")
    res = {"outputs": max(float(np.abs(a - b).max() / np.abs(b).max())
                          for a, b in zip(o_g, o_c)),
           "loss": abs(l_g - l_c) / abs(l_c), "grad_rel_l2": _rel_l2(g_g,
                                                                     g_c)}
    if any(res[k] > v for k, v in DGSSM_TOL.items()):
        raise AssertionError(f"dgssm reference: {res} against {DGSSM_TOL}")
    print(f"dgssm reference: step card vs CPU {res} (limits {DGSSM_TOL}) "
          f"on {card}", flush=True)
    return res


def _time_slice_call(kind: str, key: str) -> dict:
    """A main-path call of K1, K2 or K5 that phases 3, 6 and 9 do not time,
    timed on random inputs of its shape (K5 with every point valid):
    kernel equal to plain first."""
    from fissure_segmentation_tpu_torch.kernels import scatter as ks
    from fissure_segmentation_tpu_torch.kernels.fps import (fps_cuda,
                                                            fps_plain)
    from fissure_segmentation_tpu_torch.kernels.knn import (knn_cuda,
                                                            knn_plain)
    g = torch.Generator(device="cuda").manual_seed(len(key))
    shape, rest = key.split("_", 1)
    b, n, c = (int(v) for v in shape.split("x"))
    lib = None
    if kind == "knn":
        kk = int(rest[2:])
        x = torch.rand((b, n, c), generator=g, device="cuda") * 2 - 1
        run, plain = (lambda: knn_cuda(x, kk, True)), \
            (lambda: knn_plain(x, kk, True))
        work = (x.numel() * 4 + b * n * kk * 8, 3 * c * b * n * n)
    elif kind == "fps":
        m = int(rest[1:])
        x = torch.rand((b, n, c), generator=g, device="cuda") * 2 - 1
        run, plain = (lambda: fps_cuda(x, m)), (lambda: fps_plain(x, m))
        work = (x.numel() * 4 + b * n + b * m * 4,
                (m - 1) * b * n * (3 * c + 1))
    else:
        rows, dt = rest.split("_")
        rows = int(rows[4:])
        idx = torch.randint(0, rows, (b, n), generator=g, device="cuda",
                            dtype=torch.int32)
        pay = torch.randn((b, n, c), generator=g, device="cuda").to(
            getattr(torch, dt))
        run, plain = (lambda: ks.scatter_rows(idx, pay, rows)), \
            (lambda: ks.scatter_rows_plain(idx, pay, rows))
        flat = ks._flat_targets(idx, rows)
        acc = torch.zeros((b * rows + 1, c), device="cuda")
        pay2 = pay.reshape(-1, c).float()

        def lib():
            acc.index_add_(0, flat, pay2)
        work = (idx.numel() * 4 + pay.numel() * pay.element_size()
                + b * rows * c * 4, pay.numel())
    got, want = run(), plain()
    for a_, w_ in zip(got if isinstance(got, tuple) else (got,),
                      want if isinstance(want, tuple) else (want,)):
        same = torch.equal(a_, w_) if kind != "scatter_rows" else \
            bool(torch.allclose(a_, w_, rtol=1e-5, atol=1e-5))
        if not same:
            raise AssertionError(f"{kind} {key}: kernel differs from plain")
    bound, by = bound_ms(*work)
    t = {"ms": median_ms(run), "plain_ms": median_ms(plain, reps=3, inner=1,
                                                     warm=1),
         "library_ms": None if lib is None else median_ms(lib),
         "bound_ms": bound, "bound_by": by, "inputs": "random"}
    print(f"{kind} {key} (random inputs): kernel == plain; kernel "
          f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({by})", flush=True)
    return t


def slice_by_call(kind: str, paths: dict, timings: dict) -> dict:
    """The PC-AE's and DSEG-AE's launches of one kernel priced by call:
    {path: {call: launches, ms, plain_ms, bound_ms, library_ms}} from the
    timings phases 3, 6 and 9 keyed by the wrapper's call key, or for a
    call they do not time, `_time_slice_call`'s."""
    timed = {t["call"]: t for t in timings.values() if "call" in t}
    out = {}
    for path, calls in paths.items():
        out[path] = {}
        for key, n in sorted(calls.get(kind, {}).items()):
            if key not in timed:
                timed[key] = _time_slice_call(kind, key)
            t = timed[key]
            out[path][key] = {"launches": n, **{
                f: t.get(f) for f in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
    return out


# ---- the dataset front end: preprocess_dataset (phases 33-36) -------------

# phase 35's chain: the entry's synthetic cases (64^3) in noisy mode, where
# every case has some 17 500 keypoints (at least --pts), then a DGCNNSeg
# fold trained on the lobe labels at the default run's widths (dynamic
# bf16, k = 40, 32 x 2048), so its kernel calls are the default run's
CHAIN_PRE_ARGV = ["--synthetic", "5", "--kp_mode", "noisy", "--feature",
                  "mind_ssc"]
CHAIN_TRAIN_ARGV = ["--data", "lobes", "--fold", "0", "--epochs", "3",
                    "--pts", "2048", "--k", "40", "--batch", "32",
                    "--train_only"]
REF_SHAPE = (96, 96, 96)
K1_ROW_BLOCK = 4096   # query rows a block of phase 34's plain comparison
# phase_preprocess_reference says why
PRE_REF_TOL = {"features": 1e-5, "rw_probs": 1e-5, "regularized_share": 0.999}


class _K6Calls:
    """Records the (shape, dtype, stride) of each K6 call the CNN makes
    (models/seg_cnn.py's module global), then calls the wrapper, which
    counts its launches as always."""

    def __init__(self):
        from fissure_segmentation_tpu_torch.models import seg_cnn
        self.mod, self.fn = seg_cnn, seg_cnn.depthwise_conv3_cuda
        self.calls = {}

    def __enter__(self):
        def rec(x, w, stride=1):
            key = (tuple(x.shape), str(x.dtype).split(".")[-1], stride)
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.fn(x, w, stride=stride)
        self.mod.depthwise_conv3_cuda = rec
        return self

    def __exit__(self, *exc):
        self.mod.depthwise_conv3_cuda = self.fn


def _k1_clouds(img, lobes, spacing):
    """The (1, N, 3) zyx grid clouds poisson_reconstruction hands K1, one a
    fissure label of the preprocessed case, on the card."""
    from fissure_segmentation_tpu_torch.preprocess.pipeline import \
        preprocess_totalsegmentator_case
    from fissure_segmentation_tpu_torch.utils.coords import kpts_to_grid
    fis = preprocess_totalsegmentator_case(img, lobes, device="cuda")[
        "fissures"]
    sp = np.asarray(spacing, np.float32)
    clouds = {}
    for f in sorted(int(v) for v in np.unique(fis) if v):
        world = np.argwhere(fis == f).astype(np.float32)[:, ::-1] * sp / sp
        g = np.ascontiguousarray(kpts_to_grid(world, fis.shape)[:, ::-1])
        clouds[f] = torch.from_numpy(g)[None].cuda()
    return clouds


def _random_walk_profile(lobes_sparse, mask, iters: int = 20) -> dict:
    """The random walk of find_lobes at the case's size: ms an iteration
    (CUDA events over `iters` iterations less those over 1), its peak
    memory, and its device busy share from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from fissure_segmentation_tpu_torch.postprocess.random_walk import \
        random_walk
    seeds = torch.as_tensor(lobes_sparse, device="cuda")
    m = torch.as_tensor(mask, device="cuda")

    def run(n):
        return random_walk((seeds != 0).float(), seeds, 4,
                           edge_weights="binary", graph_mask=m, cg_iters=n)
    run(2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = {}
    for n in (1, iters):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        run(n)
        b.record()
        torch.cuda.synchronize()
        times[n] = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() - base
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(iters)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total
               for e in device_rows(prof.key_averages())) / 1e3
    # a CG iteration reads p, r, x, the weights and writes x, r, p, Ap:
    # at least 9 fields of (4, D, H, W) float32 and 4 of (D, H, W)
    n_vox = int(np.prod(mask.shape))
    bound, by = bound_ms((9 * 4 + 4) * 4 * n_vox, 40 * 4 * n_vox)
    return {"ms_per_iter": (times[iters] - times[1]) / (iters - 1),
            "peak_bytes": peak, "busy_share": busy / wall,
            "profiled_ms": wall, "iter_bound_ms": bound,
            "iter_bound_by": by}


def phase_preprocess(ks, knn_cuda, card: str, out_dir: str):
    """process_case on one synthetic 256^3 case on the card, Förstner
    keypoints with MIND-SSC features (the entry's flags), then again in
    the cnn keypoint mode with a seeded MobileNetASPP written as .fst by
    the port (its softmax in bfloat16: K6 in bf16). Counts from 0 before
    each run and read after it. Checks: success, lobes exactly {1, 2, 3, 4}
    (exclude_rhf), every fissure mesh non-empty, >= 2048 keypoints, (N, 12)
    finite features (cnn: (N, 5^3 * 4)), K1 launched once a fissure label
    at least, K6 at both strides in the cnn run, the files read back by
    load_case_npz. Prints the synced seconds of each stage, the peak
    memory, the launches; then the random walk's ms an iteration, peak
    memory and busy share, one lobe mesh's marching time and peak, and
    the CNN's forward alone in bfloat16 and float32.
    Returns ({run: counts}, {run: K1 calls}, K6 calls, clouds, timing)."""
    from fissure_segmentation_tpu_torch import preprocess_dataset
    from fissure_segmentation_tpu_torch.data.dataset import load_case_npz
    from fissure_segmentation_tpu_torch.kernels.depthwise import \
        depthwise_conv3_cuda
    from fissure_segmentation_tpu_torch.models.io import load_fst, save_fst
    from fissure_segmentation_tpu_torch.models.seg_cnn import \
        predict_full_volume
    from fissure_segmentation_tpu_torch.preprocess.labels import (
        find_lobes, label_to_mesh)
    t0 = time.perf_counter()
    case = synthetic_ct()
    img = case["image"] * 1000.0
    gen_s = time.perf_counter() - t0
    fst = os.path.join(out_dir, "cnn", "model.fst")
    save_fst(_cnn_model(0), fst)
    counts, knn_calls, timing = {}, {}, {"case_generation_s": gen_s}
    k6 = _K6Calls()
    for run, kw in (("foerstner", dict(kp_mode="foerstner",
                                       feature_mode="mind_ssc")),
                    ("cnn", dict(kp_mode="cnn", cnn_model_path=fst))):
        d = os.path.join(out_dir, run)
        os.makedirs(d, exist_ok=True)
        stages = {}
        _reset(ks, knn_cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with k6:
            out = preprocess_dataset.process_case(
                img, case["lobes"], case["spacing"], d, case["case_id"],
                stages=stages,
                generator=torch.Generator(device="cuda").manual_seed(0), **kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts[run] = _counts(ks, knn_cuda)
        counts[run]["depthwise_conv3_stride2"] = \
            depthwise_conv3_cuda.roles["stride2"]
        counts[run]["depthwise_conv3_forward"] = \
            depthwise_conv3_cuda.roles["forward"]
        knn_calls[run] = _slice_calls(ks, knn_cuda)
        others = {k: v for k, v in counts[run].items() if v and k not in (
            "knn", "depthwise_conv3", "depthwise_conv3_forward",
            "depthwise_conv3_stride2")}
        if others:
            raise AssertionError(f"preprocess {run}: launches {others} "
                                 "outside K1 and K6")
        what = f"preprocess {run}"
        if not out["lobes_success"]:
            raise AssertionError(f"{what}: find_lobes failed")
        if set(np.unique(out["lobes"])) != {0, 1, 2, 3, 4}:
            raise AssertionError(f"{what}: lobes {np.unique(out['lobes'])}, "
                                 "not exactly 1-4 (exclude_rhf)")
        n_labels = len(out["fissure_meshes"])
        tri = [int(v.sum()) for _, v in out["fissure_meshes"]]
        if n_labels != 3 or min(tri) == 0:
            raise AssertionError(f"{what}: fissure meshes {tri}")
        pts = out["points"]
        n_kp, feats = len(pts["coords"]), pts["features"]
        want_f = 12 if run == "foerstner" else 125 * 4
        if n_kp < 2048 or feats.shape != (n_kp, want_f) or \
                not np.isfinite(feats).all():
            raise AssertionError(f"{what}: {n_kp} keypoints, features "
                                 f"{feats.shape}, not finite or misshapen")
        if counts[run]["knn"] < n_labels:
            raise AssertionError(f"{what}: K1 launched {counts[run]['knn']} "
                                 f"times for {n_labels} fissure labels")
        if run == "cnn" and (counts[run]["depthwise_conv3_forward"] < 7 or
                             counts[run]["depthwise_conv3_stride2"] < 1):
            raise AssertionError(f"{what}: K6 launches {counts[run]}")
        back = load_case_npz(os.path.join(
            d, f"{case['case_id']}_points_fixed.npz"))
        if not np.array_equal(back["coords"], pts["coords"]):
            raise AssertionError(f"{what}: the point file reads back "
                                 "otherwise")
        with np.load(os.path.join(d, f"{case['case_id']}_img_fixed.npz")) as z:
            if set(z.files) != {"image", "lobes", "fissures", "lung_mask",
                                "mask_lr", "spacing"}:
                raise AssertionError(f"{what}: image file keys {z.files}")
            crop = z["image"].shape
            lung = z["lung_mask"]
            vol = torch.from_numpy(z["image"]).cuda()
        timing[run] = {"wall_s": wall, "stages_s": stages,
                       "peak_bytes": peak, "keypoints": n_kp,
                       "crop": list(crop), "fissure_triangles": tri,
                       "launches": {k: v for k, v in counts[run].items() if v}}
        print(f"{what}: {wall:.2f} s for the case (crop {crop}), "
              f"{n_kp} keypoints, fissure triangles {tri}, peak "
              f"{peak / 2 ** 30:.2f} GiB; stages (s, synced): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; launches {timing[run]['launches']}; K1 calls "
              f"{knn_calls[run]['knn']} on {card}", flush=True)
        if run == "cnn":
            # the CNN's whole-volume forward alone (after the counts are
            # read), in bfloat16 as the cnn mode runs it and in float32
            cnn = load_fst(fst).cuda().eval()
            for dt in (torch.bfloat16, torch.float32):
                timing[f"cnn_forward_{str(dt)[6:]}_ms"] = median_ms(
                    lambda: predict_full_volume(cnn, vol, dtype=dt), reps=3,
                    inner=1, warm=1)
            print(f"preprocess cnn: the CNN forward at {crop} "
                  f"{timing['cnn_forward_bfloat16_ms']:.3f} ms in bfloat16, "
                  f"{timing['cnn_forward_float32_ms']:.3f} ms in float32 "
                  f"(CUDA events, median of 3) on {card}", flush=True)
        if run == "foerstner":
            # the random walk alone, at this case's size
            sparse, ok = find_lobes(out["fissures_regularized"], lung,
                                    exclude_rhf=True, fill=False,
                                    device="cuda")
            rw = _random_walk_profile(sparse, lung)
            timing["random_walk"] = rw
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            label_to_mesh(torch.as_tensor(out["lobes"], device="cuda"), 1)
            torch.cuda.synchronize()
            timing["lobe_mesh"] = {
                "s": time.perf_counter() - t0,
                "peak_bytes": torch.cuda.max_memory_allocated() - base}
            print(f"preprocess random walk at {crop} x 4 objects: "
                  f"{rw['ms_per_iter']:.3f} ms an iteration (bound "
                  f"{rw['iter_bound_ms']:.3f}, {rw['iter_bound_by']}), peak "
                  f"{rw['peak_bytes'] / 2 ** 30:.2f} GiB, busy share "
                  f"{rw['busy_share']:.3f}; one lobe mesh (max_tris 200 000) "
                  f"{timing['lobe_mesh']['s']:.3f} s, peak "
                  f"{timing['lobe_mesh']['peak_bytes'] / 2 ** 30:.2f} GiB on "
                  f"{card}", flush=True)
    clouds = _k1_clouds(img, case["lobes"], case["spacing"])
    return counts, knn_calls, k6.calls, clouds, timing


def _knn_rows_plain(x, rows, kk):
    """knn_plain's result for the query rows `rows` of x (1, N, C): the
    same squared differences summed in channel order, a stable sort."""
    d = None
    for ch in range(x.shape[-1]):
        diff = x[0, rows, None, ch] - x[0, None, :, ch]
        sq = diff * diff
        d = sq if d is None else d + sq
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return idx[:, :kk].to(torch.int32), dist[:, :kk]


def phase_preprocess_kernels(clouds, k6_calls):
    """K1 at this slice's clouds (each fissure label's voxel cloud, kk =
    30 with the self loop): indices and distances equal to knn_plain's on
    every query row, compared in row blocks of K1_ROW_BLOCK (knn_plain
    itself would hold N^2 distances); median times of the kernel and of
    the blocked plain version, and the bound. Then K6 at every (shape,
    dtype, stride) the cnn run gave it: outputs equal to the plain version
    on random inputs of that shape; times of the kernel, the plain version
    and cuDNN's grouped conv3d, and the bound. Returns ({K1 call: timing},
    {K6 call: timing}, max |kernel - plain|)."""
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_cuda, depthwise_conv3_plain)
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    k1, k6, max_err = {}, {}, 0.0
    for f, x in clouds.items():
        n, kk = x.shape[1], 30
        idx, dist = knn_cuda(x, kk, self_loop=True)
        torch.cuda.synchronize()

        def plain():
            out = [_knn_rows_plain(x, torch.arange(
                s, min(s + K1_ROW_BLOCK, n), device=x.device), kk)
                for s in range(0, n, K1_ROW_BLOCK)]
            return torch.cat([o[0] for o in out]), torch.cat(
                [o[1] for o in out])
        i_p, d_p = plain()
        if not (torch.equal(idx[0], i_p) and torch.equal(dist[0], d_p)):
            raise AssertionError(f"K1 fissure {f} (1, {n}, 3): kernel "
                                 f"differs from plain in "
                                 f"{(idx[0] != i_p).any(-1).sum().item()} "
                                 "rows")
        t_k = median_ms(lambda: knn_cuda(x, kk, self_loop=True), reps=5,
                        inner=3, warm=1)
        t_p = median_ms(plain, reps=3, inner=1, warm=1)
        bound, by = bound_ms(x.numel() * 4 + n * kk * 8, 3 * 3 * n * n)
        key = f"1x{n}x3_kk{kk}"
        k1[key] = {"call": key, "ms": t_k, "plain_ms": t_p,
                   "plain": f"row blocks of {K1_ROW_BLOCK}",
                   "bound_ms": bound, "bound_by": by, "library_ms": None}
        print(f"K1 preprocess fissure {f} (1, {n}, 3) kk={kk}: kernel == "
              f"plain (indices, distances; every row, blocks of "
              f"{K1_ROW_BLOCK}); kernel {t_k:.4f} ms, plain {t_p:.4f} ms "
              f"(median), bound {bound:.4f} ms ({by})", flush=True)
    g = torch.Generator(device="cuda").manual_seed(15)
    for (shape, dt, s), n_calls in sorted(k6_calls.items()):
        dtype = getattr(torch, dt)
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        w = torch.randn((3, 3, 3, shape[-1]), generator=g,
                        device="cuda").to(dtype)
        got = depthwise_conv3_cuda(x, w, s)
        want = depthwise_conv3_plain(x, w, s)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"K6 preprocess {shape} {dt} stride {s}: "
                                 f"kernel differs from plain (max {err:.3g})")
        t_k = median_ms(lambda: depthwise_conv3_cuda(x, w, s), reps=5,
                        inner=3, warm=1)
        t_p = median_ms(lambda: depthwise_conv3_plain(x, w, s), reps=3,
                        inner=1, warm=1)
        t_l = median_ms(lambda: _dw_library(x, w, s), reps=3, inner=1,
                        warm=1)
        bound, by = bound_ms((x.numel() + got.numel() + w.numel())
                             * x.element_size(), 54 * got.numel())
        key = f"{'x'.join(map(str, shape))}_{dt}_s{s}"
        k6[key] = {"launches_per_forward": n_calls, "ms": t_k,
                   "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                   "library_ms": t_l}
        print(f"K6 preprocess {key} ({n_calls} a forward): kernel == "
              f"plain; kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library "
              f"conv3d {t_l:.4f} ms, bound {bound:.4f} ms ({by})",
              flush=True)
        del x, w, got, want
        torch.cuda.empty_cache()
    return k1, k6, max_err


def phase_chain(ks, knn_cuda, card: str, out_dir: str):
    """The chain from CTs to a tested fold on the card: preprocess_dataset.
    main with CHAIN_PRE_ARGV (5 synthetic cases at the entry's 64^3), then
    train_point_seg.main on that folder with CHAIN_TRAIN_ARGV (lobe labels,
    fold 0, 3 epochs), then fold 0's test through the lobes label space
    (test_pipeline, the cases given their fissure labels and the lung mask
    of their image file). Counts from 0 before the two runs, read after
    the test. Checks: every case written, finite losses, finite Dice, the
    random walk run on the card. Returns (counts, {kind: calls} of K1, K2
    and K5, the gather-reduce's calls, K4's calls, timing)."""
    import fissure_segmentation_tpu_torch.postprocess.random_walk as rwm
    from fissure_segmentation_tpu_torch import (preprocess_dataset,
                                                train_point_seg)
    from fissure_segmentation_tpu_torch.data.dataset import (
        PointDataset, load_case_npz, load_split_file)
    from fissure_segmentation_tpu_torch.models.weights import load_model
    from fissure_segmentation_tpu_torch.train.evaluation import test_pipeline
    data, run = os.path.join(out_dir, "data"), os.path.join(out_dir, "run")
    _reset(ks, knn_cuda)
    t0 = time.perf_counter()
    preprocess_dataset.main(CHAIN_PRE_ARGV + ["--output", data])
    pre_s = time.perf_counter() - t0
    n_pts = {}
    for i in range(5):
        c = load_case_npz(os.path.join(data,
                                       f"synthimg{i:04d}_points_fixed.npz"))
        n_pts[c["case_id"]] = len(c["coords"])
    pts = int(CHAIN_TRAIN_ARGV[CHAIN_TRAIN_ARGV.index("--pts") + 1])
    if min(n_pts.values()) < pts:
        raise AssertionError(f"chain: keypoints a case {n_pts}, fewer than "
                             f"--pts {pts}")
    t0 = time.perf_counter()
    train_point_seg.main(["--data_dir", data, "--output", run]
                         + CHAIN_TRAIN_ARGV)
    train_s = time.perf_counter() - t0
    losses = _read_history(os.path.join(run, "fold0", "history.csv"))
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"chain: losses {losses}")
    val = load_split_file(os.path.join(run, "cross_val_split.json"))[0]["val"]
    cases = []
    for cid, seq in val:
        c = load_case_npz(os.path.join(data, f"{cid}_points_{seq}.npz"))
        c["fissure_labels"] = c["labels"]
        with np.load(os.path.join(data, f"{cid}_img_{seq}.npz")) as z:
            c["lung_mask"] = z["lung_mask"]
        cases.append(c)
    ds = PointDataset(cases, sample_points=pts, lobes=True)
    model = load_model(os.path.join(run, "fold0", "model.pt")).cuda().eval()
    devices, rw = [], rwm.random_walk

    def record(im, *a, **k):
        devices.append(im.device.type)
        return rw(im, *a, **k)
    rwm.random_walk = record
    try:
        t0 = time.perf_counter()
        res = test_pipeline(ds, model, os.path.join(run, "fold0",
                                                    "test_lobes"),
                            sample_points=pts, label_space="lobes")
        test_s = time.perf_counter() - t0
    finally:
        rwm.random_walk = rw
    counts, calls = _counts(ks, knn_cuda), _slice_calls(ks, knn_cuda)
    gr, k4 = _gr_calls(ks, knn_cuda), dict(ks.scatter_count.calls)
    if not devices or set(devices) != {"cuda"}:
        raise AssertionError(f"chain: the random walk ran on {devices}")
    if not np.isfinite(res["dice"]).all():
        raise AssertionError(f"chain: Dice {res['dice']}")
    timing = {"preprocess_s": pre_s, "keypoints": n_pts, "train_s": train_s,
              "losses": losses, "test_s": test_s,
              "dice": res["dice"].tolist(), "assd": res["assd"].tolist(),
              "random_walks": len(devices),
              "launches": {k: v for k, v in counts.items() if v}}
    print(f"chain: preprocess_dataset --synthetic 5 (64^3, noisy) "
          f"{pre_s:.1f} s, keypoints {n_pts}; train_point_seg --data lobes "
          f"{train_s:.1f} s, losses {[round(v, 4) for v in losses]}; test "
          f"in the lobes label space {test_s:.1f} s ({len(devices)} random "
          f"walks on the card): Dice {np.round(res['dice'], 4).tolist()}, "
          f"ASSD {np.round(res['assd'], 3).tolist()}; launches "
          f"{timing['launches']} on {card}", flush=True)
    return counts, calls, gr, k4, timing


def phase_preprocess_reference(card: str, out_dir: str):
    """One REF_SHAPE case through process_case (Förstner, MIND-SSC) on the
    card and on the CPU with the same injected draws. The Poisson step's
    PSR runs through cuFFT on the card and pocketfft on the CPU, which
    move vertices by ulps, so the CPU's own regularized labelmap is held
    to PRE_REF_TOL["regularized_share"] of the card's voxels and the CPU
    chain then goes on from the card's (as the CPU tests go on from
    JAX's): fissures, lung mask, mask_lr, keypoints, labels and lobes
    equal; features within PRE_REF_TOL["features"] of their largest entry
    (float32 sums in other orders); the random walk's probabilities at 20
    iterations within PRE_REF_TOL["rw_probs"] (alpha and beta are sums over
    every voxel, added in other orders)."""
    import fissure_segmentation_tpu_torch.preprocess.pipeline as pipe
    from fissure_segmentation_tpu_torch import preprocess_dataset
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.postprocess.random_walk import \
        random_walk
    from fissure_segmentation_tpu_torch.preprocess.labels import find_lobes
    case = make_synthetic_image_case(0, shape=REF_SHAPE)
    img = case["image"] * 1000.0
    crop = pipe.preprocess_totalsegmentator_case(img, case["lobes"],
                                                 device="cpu")
    scores = torch.rand(crop["image"].size,
                        generator=torch.Generator().manual_seed(3))
    rec, poisson = {}, pipe.poisson_reconstruction

    def on_card(*a, **k):
        rec["cuda"] = poisson(*a, **k)
        return rec["cuda"]

    def on_cpu(*a, **k):
        rec["cpu"] = poisson(*a, **k)
        return rec["cuda"]
    outs = {}
    try:
        for dev, fn in (("cuda", on_card), ("cpu", on_cpu)):
            pipe.poisson_reconstruction = fn
            d = os.path.join(out_dir, dev)
            os.makedirs(d, exist_ok=True)
            t0 = time.perf_counter()
            outs[dev] = preprocess_dataset.process_case(
                img, case["lobes"], case["spacing"], d, "ref",
                kp_mode="foerstner", feature_mode="mind_ssc", device=dev,
                draws={"scores": scores})
            outs[dev]["s"] = time.perf_counter() - t0
            with np.load(os.path.join(d, "ref_img_fixed.npz")) as z:
                outs[dev]["img_file"] = {k: z[k] for k in z.files}
    finally:
        pipe.poisson_reconstruction = poisson
    a, b = outs["cuda"], outs["cpu"]
    for k in ("image", "fissures", "lung_mask", "mask_lr", "lobes"):
        if not np.array_equal(a["img_file"][k], b["img_file"][k]):
            raise AssertionError(f"preprocess reference: {k} differs")
    share = float((rec["cpu"][0] == rec["cuda"][0]).mean())
    if share < PRE_REF_TOL["regularized_share"]:
        raise AssertionError(f"preprocess reference: regularized labelmaps "
                             f"agree on {share:.5f} of the voxels")
    if not np.array_equal(a["lobes"], b["lobes"]):
        raise AssertionError("preprocess reference: lobes differ")
    pa, pb = a["points"], b["points"]
    for k in ("coords", "labels", "lobes"):
        if not np.array_equal(pa[k], pb[k]):
            raise AssertionError(f"preprocess reference: points' {k} differ")
    f_err = float(np.abs(pa["features"] - pb["features"]).max()
                  / np.abs(pb["features"]).max())
    if f_err > PRE_REF_TOL["features"]:
        raise AssertionError(f"preprocess reference: features {f_err:.3g} "
                             "of their largest entry apart")
    sparse, _ = find_lobes(a["fissures_regularized"],
                           a["img_file"]["lung_mask"], exclude_rhf=True,
                           fill=False, device="cpu")
    probs = {}
    for dev in ("cuda", "cpu"):
        s = torch.as_tensor(sparse, device=dev)
        probs[dev] = random_walk(
            (s != 0).float(), s, 4, graph_mask=torch.as_tensor(
                a["img_file"]["lung_mask"], device=dev),
            cg_iters=20).cpu().numpy()
    rw_err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    if rw_err > PRE_REF_TOL["rw_probs"]:
        raise AssertionError(f"preprocess reference: random-walk "
                             f"probabilities {rw_err:.3g} apart")
    out = {"regularized_share": share, "features_rel_err": f_err,
           "rw_probs_max_abs": rw_err, "keypoints": len(pa["coords"]),
           "card_s": a["s"], "cpu_s": b["s"]}
    print(f"preprocess reference at {REF_SHAPE}: image file, keypoints, "
          f"labels and lobes equal card vs CPU; regularized labelmaps agree "
          f"on {share:.6f} of the voxels; features {f_err:.3g} of their "
          f"largest entry; random walk (20 iterations) {rw_err:.3g}; card "
          f"{a['s']:.2f} s, CPU {b['s']:.2f} s on {card}", flush=True)
    return out


# ---- the rest of the point models (phases 37-40) ---------------------------

# phase 37: PointNet through the entry, BASELINE's first configuration
# (--amp true, the CLI default: bf16 shared MLPs)
POINTNET_ARGV = ["--model", "PointNet", "--ds", "synthetic", "--fold", "0",
                 "--epochs", "3", "--pts", "2048", "--batch", "32"]
# phase 39: DGCNN with both stems, bf16, trained only (--static added for
# the static run)
STEMS_ARGV = ["--ds", "synthetic", "--fold", "0", "--epochs", "3", "--pts",
              "2048", "--k", "40", "--batch", "32", "--transformer",
              "--img_feat_extractor", "--train_only"]
AFFINE_EPOCHS, AFFINE_STEPS = 2, 10
# phase_pointnet_reference and phase_affine_reference say why
POINTNET_TOL = {"loss": 1e-4, "logits": 1e-4, "grad_rel_l2": 0.05,
                "bf16_slack": 1.3}
AFFINE_TOL = {"outputs": 1e-4, "loss": 1e-4, "grad_rel_l2": 1e-2}


def _profiled_busy(step, steps: int = 3) -> float:
    """The device's busy share over `steps` warm steps: summed device time
    of the profiler's kernels over the host clock."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total
               for e in device_rows(prof.key_averages())) / 1e3
    return busy / wall


def _timed_steps(ks, knn_cuda, step, what: str) -> dict:
    """WARM warm-up steps, then STEPS timed ones (ms/step, clouds/s of 32,
    peak memory, the launches a step) and the busy share over 3 more."""
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM, time_steps)
    for _ in range(WARM):
        step()
    before = _counts(ks, knn_cuda)
    ms, peak, losses = time_steps(step)
    after = _counts(ks, knn_cuda)
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"{what}: non-finite loss in the timed steps")
    return {"ms_per_step": ms, "clouds_per_s": 32e3 / ms,
            "peak_gib": peak / 2 ** 30,
            "launches_per_step": {k: (after[k] - before[k]) / STEPS
                                  for k in after if after[k] - before[k]},
            "busy_share": _profiled_busy(step)}


def _pointnet_runs(train_point_seg, card: str, out_dir: str,
                   timing: dict) -> None:
    """Phase 37's entry runs (phase_pointnet says which), into `timing`."""
    from fissure_segmentation_tpu_torch.models import (PointNetSeg,
                                                       load_fold_model)
    for name, extra in (("pointnet", []), ("transformer", ["--transformer"])):
        run = os.path.join(out_dir, name)
        t0 = time.perf_counter()
        if train_point_seg.main(POINTNET_ARGV + extra + ["--output",
                                                        run]) != 0:
            raise AssertionError(f"pointnet ({name}): the entry failed")
        took = time.perf_counter() - t0
        fold = os.path.join(run, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        model = load_fold_model(fold)
        if len(hist) != 3 or not np.isfinite(hist).all() or \
                not isinstance(model, PointNetSeg) or \
                model.dtype != torch.bfloat16 or \
                model.spatial_transform != bool(extra):
            raise AssertionError(f"pointnet ({name}): history {hist}, "
                                 f"model.pt {type(model).__name__} "
                                 f"{model.config}")
        inf, post = _check_test_outputs(os.path.join(fold, "test"), "",
                                        f"pointnet ({name})")
        modes = (["--test_only", "--fold", "0"], ["--speed"]) if not extra \
            else (["--speed"],)
        row = {"train_and_test_s": took, "loss_history": hist,
               "inference_s_per_case": inf, "post_s_per_case": post}
        for mode in modes:
            if train_point_seg.main(["--output", run] + mode) != 0:
                raise AssertionError(f"pointnet ({name}): {mode[0]} failed")
            if mode[0] == "--test_only":
                row["test_only"] = _check_test_outputs(
                    os.path.join(fold, "test"), "", "pointnet --test_only")
            else:
                speed = _csv(os.path.join(run, "inference_time.csv"))
                row["speed_ms"] = float(speed[1][0]) * 1e3
        timing[name] = row
        print(f"pointnet ({name}): {json.dumps(row)} on {card}", flush=True)

    # F15's path: the fold as model.fst alone, read by --test_only
    run, fst_run = (os.path.join(out_dir, n) for n in ("pointnet", "fst"))
    _copy_fold_as_fst(run, fst_run)
    args_path = os.path.join(fst_run, "commandline_args.json")
    with open(args_path) as f:
        stored = json.load(f)
    with open(args_path, "w") as f:       # the test modes keep --output's
        json.dump({**stored, "output": fst_run}, f)
    if train_point_seg.main(["--output", fst_run, "--test_only", "--fold",
                             "0"]) != 0:
        raise AssertionError("pointnet: --test_only of the .fst fold failed")
    if os.path.exists(os.path.join(fst_run, "fold0", "model.pt")):
        raise AssertionError("pointnet: the .fst fold grew a model.pt")
    timing["fst_test_only"] = _check_test_outputs(
        os.path.join(fst_run, "fold0", "test"), "", "pointnet .fst")


def phase_pointnet(ks, knn_cuda, card: str, out_dir: str):
    """PointNet at full width through the entry (POINTNET_ARGV: 3 epochs of
    fold 0 at 32 x 2048 on the synthetic cases, bf16 shared MLPs, then
    fold 0's test): model.pt a PointNetSeg in bf16, finite losses, the test
    CSVs (phase 20's checks); --test_only, --speed; the fold re-written as
    model.fst alone (F15's path) and tested by --test_only; one warm-up and
    3 timed segment_case cases on the 256^3 CT with the fold's model (the
    synthetic cases' feature channel served as 0: segment_case hands the
    model coordinates) and phase 4's class bias, under phase 4's checks;
    the same entry with --transformer (the input T-Net) trained, tested
    and timed by --speed (the entry runs share one synthetic dataset);
    10 timed warm steps of PointNetSeg bf16, f32 and bf16 with the input
    T-Net (ms/step, clouds/s, peak memory, busy share). PointNet launches
    no kernel; serving's surface fit launches K1 (normals). Counts are
    reset before and read after; returns (counts, calls, timing)."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import load_fold_model
    from fissure_segmentation_tpu_torch.serving import segment_case
    from fissure_segmentation_tpu_torch.train.profile_step import (
        canonical_data, make_step)
    _reset(ks, knn_cuda)
    timing = {}
    with _cached_synthetic(train_point_seg):
        _pointnet_runs(train_point_seg, card, out_dir, timing)
    run = os.path.join(out_dir, "pointnet")

    # serving with the fold's model
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    model = load_fold_model(os.path.join(run, "fold0")).cuda().eval()
    pad = model.config["in_features"] - 3

    def coords_model(x):
        """segment_case hands the model grid coordinates; the fold reads
        them and the synthetic cases' feature channel, served as 0."""
        return model(torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], -1))
    apply = biased_model(coords_model, case, SHAPE)

    def serve(seed):
        return segment_case(vol, mask, apply,
                            torch.Generator().manual_seed(seed),
                            center_x=SHAPE[2] / 2)
    check_result(serve(1), SHAPE, "pointnet warm-up case")
    times, k1 = [], knn_cuda.launches
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = serve(2 + i)
        times.append(time.perf_counter() - t0)
        check_result(res, SHAPE, f"pointnet case {i}")
    if knn_cuda.launches - k1 < 3:
        raise AssertionError("pointnet serving: K1 (normals) not launched "
                             "every case")
    timing["serving_s_per_case"] = times
    del vol, mask
    torch.cuda.empty_cache()

    ds, loss_fn = canonical_data()
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in (("bf16", dict(dtype=torch.bfloat16)),
                         ("f32", {}),
                         ("bf16_transformer", dict(dtype=torch.bfloat16,
                                                   spatial_transform=True))):
            step = make_step(ds, loss_fn, tmp, model="PointNet", **kw)
            timing[f"step_{name}"] = _timed_steps(ks, knn_cuda, step,
                                                  f"pointnet {name}")
    steps = {k: v for k, v in timing.items() if k.startswith("step_")}
    print(f"pointnet: serving {[round(t, 4) for t in times]} s/case; "
          f"steps {json.dumps(steps)} on {card}", flush=True)
    return _counts(ks, knn_cuda), _slice_calls(ks, knn_cuda), timing


def phase_pointnet_features(card: str, data: str, out_dir: str) -> dict:
    """PointNet (the entry's defaults, bf16) trained 3 epochs on fold 0 of
    the point files phase 35's preprocess_dataset wrote with --feature
    mind_ssc (12 MIND-SSC channels a keypoint: BASELINE's "w/ image
    features") and tested: in_features 15, finite losses and Dice, the
    test CSV's layout (the point files carry no GT surfaces, so the ASSD
    family stays NaN, as in phase 35)."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import load_fold_model
    run = os.path.join(out_dir, "pointnet_mind_ssc")
    argv = ["--model", "PointNet", "--data_dir", data, "--fold", "0",
            "--epochs", "3", "--pts", "2048", "--batch", "32", "--output",
            run]
    t0 = time.perf_counter()
    if train_point_seg.main(argv) != 0:
        raise AssertionError("pointnet (mind_ssc): the entry failed")
    took = time.perf_counter() - t0
    fold = os.path.join(run, "fold0")
    hist = _read_history(os.path.join(fold, "history.csv"))
    model = load_fold_model(fold)
    rows = _csv(os.path.join(fold, "test", "test_results.csv"))
    dice = np.asarray(rows[1][1:], float)
    if model.config["in_features"] != 15 or not np.isfinite(hist).all() \
            or [r[0] if r else None for r in rows] != RESULT_ROWS or \
            not np.isfinite(dice).all():
        raise AssertionError(f"pointnet (mind_ssc): {model.config}, {hist}, "
                             f"{rows}")
    speed = _csv(os.path.join(fold, "test", "inference_time.csv"))
    out = {"train_and_test_s": took, "loss_history": hist,
           "inference_s_per_case": float(speed[1][0]),
           "post_s_per_case": float(speed[1][2]),
           "mean_dice": dice.tolist()}
    print(f"pointnet (mind_ssc): {json.dumps(out)} on {card}", flush=True)
    return out


def _step_on(dev, model0, x, y, cw):
    """One NNU-loss train forward and backward of a copy of `model0` on
    `dev`: (loss, eval logits of the copy before the step, gradient)."""
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    m = copy.deepcopy(model0).to(dev)
    with torch.no_grad():
        logits = m.eval()(x.to(dev)).float().cpu()
    m.train()
    loss, _ = get_loss_fn("nnunet", cw.to(dev))(m(x.to(dev)), y.to(dev))
    loss.backward()
    return float(loss.detach()), logits, _grads(m)


def _small_batch(seed: int, n_cases: int = 3, b: int = 4):
    """(dataset, x (b, 256, C), y, class weights) from synthetic cases of
    600 points."""
    from fissure_segmentation_tpu_torch.data.dataset import PointDataset
    from fissure_segmentation_tpu_torch.data.store import sample_batch
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    ds = PointDataset(make_synthetic_dataset(n_cases, n_points=600),
                      sample_points=256)
    x, y = sample_batch(ds.to_store(device="cuda"),
                        torch.arange(b, device="cuda") % n_cases,
                        ds.sample_points,
                        torch.Generator(device="cuda").manual_seed(seed))
    return ds, x, y, torch.as_tensor(ds.get_class_weights())


def phase_pointnet_reference(card: str) -> dict:
    """One train step and one eval forward of PointNetSeg with both T-Nets
    on 4 clouds of 256 points, card against CPU from the same weights and
    batch. float32: loss within rtol POINTNET_TOL["loss"], eval logits
    within POINTNET_TOL["logits"] of their largest entry, the whole
    gradient within POINTNET_TOL["grad_rel_l2"] in relative L2: train-mode
    BatchNorm over the T-Nets' one vector a cloud amplifies summation-order
    rounding (on the CPU JAX's own float32 gradient is up to 1.4 % off its
    float64 one, tests/test_torch_pointnet.py). bf16 (the shared MLPs),
    held as phase 18 holds DGCNN's: loss and eval logits against the CPU's
    bf16 ones within BF16_TOL; the gradient no further from the CPU's
    float32 one than the CPU's bf16 gradient is, times
    POINTNET_TOL["bf16_slack"] (bf16 through the T-Nets' train-mode
    BatchNorm moves the whole gradient by tens of percent on either side,
    so card against CPU in bf16 would measure that amplification)."""
    from fissure_segmentation_tpu_torch.models import PointNetSeg
    ds, x, y, cw = _small_batch(38)
    res = {}
    runs = {}
    for dt in (None, torch.bfloat16):
        model0 = _draw_bn_offsets(PointNetSeg(
            ds.n_features, ds.num_classes, True, True, dtype=dt,
            generator=torch.Generator().manual_seed(38)), 38)
        runs[dt] = [_step_on(dev, model0, x, y, cw)
                    for dev in ("cuda", "cpu")]
    (l_g, lo_g, g_g), (l_c, lo_c, g_c) = runs[None]
    res["f32"] = {"loss": abs(l_g - l_c) / abs(l_c),
                  "logits": float((lo_g - lo_c).abs().max()
                                  / lo_c.abs().max()),
                  "grad_rel_l2": _rel_l2(g_g, g_c)}
    (b_g, blo_g, bg_g), (b_c, blo_c, bg_c) = runs[torch.bfloat16]
    res["bf16"] = {
        "loss": abs(b_g - b_c) / abs(b_c),
        "logits": float((blo_g - blo_c).abs().max() / blo_c.abs().max()),
        "grad_vs_cpu_f32": [_rel_l2(bg_g, g_c), _rel_l2(bg_c, g_c)]}
    print(f"pointnet reference: card vs CPU {json.dumps(res)} (limits "
          f"{POINTNET_TOL}, BF16_TOL {BF16_TOL}) on {card}", flush=True)
    if any(res["f32"][k] > POINTNET_TOL[k] for k in res["f32"]):
        raise AssertionError(f"pointnet reference f32: {res['f32']} against "
                             f"{POINTNET_TOL}")
    card_err, cpu_err = res["bf16"]["grad_vs_cpu_f32"]
    if res["bf16"]["loss"] > BF16_TOL["loss"] or \
            res["bf16"]["logits"] > BF16_TOL["logits"] or \
            card_err > POINTNET_TOL["bf16_slack"] * cpu_err:
        raise AssertionError(f"pointnet reference bf16: {res['bf16']} "
                             f"against {BF16_TOL} and the slack "
                             f"{POINTNET_TOL['bf16_slack']}")
    return res


def phase_stems(ks, knn_cuda, card: str, out_dir: str):
    """DGCNN with both stems through the entry (STEMS_ARGV: bf16, k = 40,
    32 x 2048, 3 epochs of fold 0), static and dynamic: model.pt with both
    options, finite losses; then 10 timed warm steps of each (ms/step,
    clouds/s, peak memory, busy share, launches a step: static K1 once,
    the transpose once (the spatial transformer's EdgeConv shares the
    static graph and its transpose); dynamic K1 twice (the transformer's
    graph and EdgeConv_0's, both of coordinates), the transpose 4 times;
    both: K2 twice (the transformer's EdgeMLP and EdgeConv_0's), the
    gather-reduce, K3 and K4 twice). Counts are reset before and read
    after; returns (counts, calls, gather-reduce calls, K4 calls,
    timing)."""
    from fissure_segmentation_tpu_torch import train_point_seg
    from fissure_segmentation_tpu_torch.models import (DGCNNSeg,
                                                       load_fold_model)
    from fissure_segmentation_tpu_torch.train.profile_step import (
        canonical_data, make_step)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    _reset(ks, knn_cuda)
    timing = {}
    with _cached_synthetic(train_point_seg):
        for name, extra in (("static", ["--static"]), ("dynamic", [])):
            run = os.path.join(out_dir, f"stems_{name}")
            t0 = time.perf_counter()
            if train_point_seg.main(STEMS_ARGV + extra
                                    + ["--output", run]) != 0:
                raise AssertionError(f"stems ({name}): the entry failed")
            took = time.perf_counter() - t0
            hist = _read_history(os.path.join(run, "fold0", "history.csv"))
            model = load_fold_model(os.path.join(run, "fold0"))
            if not isinstance(model, DGCNNSeg) or model.dynamic != (
                    name == "dynamic") or model.dtype != torch.bfloat16 or \
                    not (model.spatial_transformer
                         and model.image_feat_module) \
                    or len(hist) != 3 or not np.isfinite(hist).all():
                raise AssertionError(f"stems ({name}): {model.config}, "
                                     f"{hist}")
            timing[name] = {"train_s": took, "loss_history": hist}
    ds, loss_fn = canonical_data()
    for name in ("static", "dynamic"):
        with tempfile.TemporaryDirectory() as tmp:
            step = make_step(ds, loss_fn, tmp, dtype=torch.bfloat16,
                             dynamic=name == "dynamic",
                             spatial_transformer=True,
                             image_feat_module=True)
            row = _timed_steps(ks, knn_cuda, step, f"stems ({name})")
        per = row["launches_per_step"]
        want = ({"knn": 1, "transpose": 1} if name == "static"
                else {"knn": 2, "transpose": 4, "select_rows": 2})
        want.update(scatter_rows=2, gather_reduce=2, scatter_routed=2,
                    scatter_count=2)
        if any(per.get(k) != n for k, n in want.items()):
            raise AssertionError(f"stems ({name}): launches a step {per}, "
                                 f"not {want}")
        timing[name].update(row)
        print(f"stems ({name}): {json.dumps(timing[name])} on {card}",
              flush=True)
    return (_counts(ks, knn_cuda), _slice_calls(ks, knn_cuda),
            _gr_calls(ks, knn_cuda), _check_k4_route(ks, "stems"), timing)


def phase_stems_reference(card: str) -> dict:
    """One bf16 train step of DGCNNSeg(k = 8, static) with both stems at
    B = 2, N = 256 on the card (kernels) and on the CPU (plain versions),
    from the same weights and batch, both routings, held within BF16_TOL as
    phase 18 holds the plain model (phase_bf16_reference says why). The
    spatial transformer and the image features compute in float32 whatever
    the model's dtype (their EdgeConv too, unfused, K2 in its backward):
    their card-vs-CPU differences are float32 rounding, far below bf16's,
    so they widen no limit; their gradient is part of the whole held
    in relative L2."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    ds, x, y, cw = _small_batch(39, b=2)
    model0 = _draw_bn_offsets(DGCNNSeg(
        k=8, in_features=ds.n_features, num_classes=ds.num_classes,
        dynamic=False, spatial_transformer=True, image_feat_module=True,
        dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(39)), 39)
    res = {}
    for fused in ("0", "1"):
        os.environ["FSEG_FUSED_EDGE"] = fused
        route = "fused" if fused == "1" else "unfused"
        m_g, l_g, c_g, _ = _reference_step("cuda", model0, ds, cw,
                                           TrainConfig(), x, y)
        m_c, l_c, c_c, _ = _reference_step("cpu", model0, ds, cw,
                                           TrainConfig(), x, y)
        _close("stems bf16 loss", l_g, l_c, rtol=BF16_TOL["loss"], atol=0)
        grad = _rel_l2(_grads(m_g), _grads(m_c))
        from fissure_segmentation_tpu_torch.models import \
            export_jax_variables
        stats = _rel_l2(*(dict(_leaves(export_jax_variables(m)[
            "batch_stats"])) for m in (m_g, m_c)))
        with torch.no_grad():
            lg = copy.deepcopy(model0).cuda().eval()(x).float().cpu()
            lc = copy.deepcopy(model0).eval()(x.cpu()).float()
        logits = float((lg - lc).abs().max() / lc.abs().max())
        res[route] = {"loss": [l_g, l_c], "grad_rel_l2": grad,
                      "stats_rel_l2": stats, "logits": logits}
        if grad > BF16_TOL["grad_rel_l2"] or \
                stats > BF16_TOL["stats_rel_l2"] or \
                logits > BF16_TOL["logits"]:
            raise AssertionError(f"stems reference ({route}): {res[route]} "
                                 f"against {BF16_TOL}")
    os.environ.pop("FSEG_FUSED_EDGE")
    print(f"stems reference: card vs CPU {json.dumps(res)} (limits "
          f"{BF16_TOL}) on {card}", flush=True)
    return res


def phase_affine(ks, knn_cuda, card: str, out_dir: str):
    """affine_experiments.run_example for each of DGCNN, OpenDGCNN and
    PointNet at the entry's widths (k = 40, 8 transforms of the 1024-point
    target a step; rotation and translation, the point loss) for
    AFFINE_EPOCHS x AFFINE_STEPS steps: finite metrics, the CSV rows; then
    10 timed warm steps of each (ms/step, peak memory, busy share, the
    launches a step: DGCNN K1 once (the coordinates; the three feature
    graphs are `feature_knn`, the fused row selection 3 times), the
    transpose, the gather-reduce, K3 and K4 4 times; OpenDGCNN K1 once and
    the row selection 3 times, the transpose and K2 4 times; PointNet
    none). Counts are reset before and read after; returns (counts, calls,
    gather-reduce calls, K4 calls, K3 calls, timing)."""
    from fissure_segmentation_tpu_torch import affine_experiments as ae
    from fissure_segmentation_tpu_torch.train.profile_step import (
        STEPS, WARM)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    _reset(ks, knn_cuda)
    timing = {}
    want = {"DGCNN": {"knn": 1, "transpose": 4, "gather_reduce": 4,
                      "scatter_routed": 4, "scatter_count": 4,
                      "select_rows": 3},
            "OpenDGCNN": {"knn": 1, "transpose": 4, "scatter_rows": 4,
                          "select_rows": 3},
            "PointNet": {}}
    for name in ("DGCNN", "OpenDGCNN", "PointNet"):
        t0 = time.perf_counter()
        hist = ae.run_example(name, AFFINE_EPOCHS, AFFINE_STEPS, out_dir)
        took = time.perf_counter() - t0
        if len(hist) != AFFINE_EPOCHS or not all(
                np.isfinite(v) for h in hist for v in h.values()):
            raise AssertionError(f"affine ({name}): history {hist}")
        rows = _csv(os.path.join(out_dir, f"{name}_sanity_check",
                                 f"{name}_rot_translation_pointloss",
                                 "training_progression.csv"))
        if [r[0] for r in rows] != ["loss", "angle_rmse", "trans_rmse_mm",
                                    "corr_err_mm"]:
            raise AssertionError(f"affine ({name}): CSV rows {rows}")
        step, _, gen = ae.build_example(name, device="cuda")
        for _ in range(WARM):
            step(gen)
        before = _counts(ks, knn_cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for _ in range(STEPS):
            m = step(gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / STEPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        after = _counts(ks, knn_cuda)
        per = {k: (after[k] - before[k]) / STEPS for k in after
               if after[k] - before[k]}
        if per != {k: float(v) for k, v in want[name].items()}:
            raise AssertionError(f"affine ({name}): launches a step {per}, "
                                 f"not {want[name]}")
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"affine ({name}): non-finite step loss")
        timing[name] = {"run_s": took, "history": hist, "ms_per_step": ms,
                        "peak_gib": peak / 2 ** 30,
                        "launches_per_step": per,
                        "busy_share": _profiled_busy(lambda: step(gen))}
        print(f"affine ({name}): {json.dumps(timing[name])} on {card}",
              flush=True)
    return (_counts(ks, knn_cuda), _slice_calls(ks, knn_cuda),
            _gr_calls(ks, knn_cuda), _check_k4_route(ks, "affine"),
            dict(ks.scatter_routed.calls), timing)


def phase_affine_reference(card: str) -> dict:
    """One experiment step of each affine model, card against CPU, from
    the same weights (k = 40) and the same 8 transforms of a 256-point
    target: the step's metrics (loss, angle_rmse, trans_rmse, corr_err)
    within rtol AFFINE_TOL["loss"], the outputs before the step within
    AFFINE_TOL["outputs"] of their largest entry, the whole gradient within
    AFFINE_TOL["grad_rel_l2"] in relative L2 (train-mode BatchNorm over the
    batch's 8 vectors in the heads amplifies summation-order rounding; on
    the CPU the port against JAX reads up to 1.2e-4,
    tests/test_torch_affine.py)."""
    from fissure_segmentation_tpu_torch import affine_experiments as ae
    from fissure_segmentation_tpu_torch.models import AFFINE_MODELS
    target_np, _ = ae.normalized_target_shape(np.random.default_rng(40),
                                              n_points=256)
    g = torch.Generator().manual_seed(40)
    draws = (torch.rand((8, 3), generator=g), torch.rand((8, 3), generator=g))
    res = {}
    for name in ("DGCNN", "OpenDGCNN", "PointNet"):
        model0 = _draw_bn_offsets(AFFINE_MODELS[name](
            k=40, generator=torch.Generator().manual_seed(40)), 40)
        out = {}
        for dev in ("cuda", "cpu"):
            m = copy.deepcopy(model0).to(dev)
            with torch.no_grad():
                before = torch.cat(m.eval()(torch.from_numpy(
                    target_np)[None].to(dev).expand(8, -1, -1)), -1).cpu()
            opt = torch.optim.Adam(m.parameters(), lr=ae.LR)
            step = ae.make_train_step(m, opt, torch.from_numpy(target_np)
                                      .to(dev), True, True, True, False)
            metrics = {k: float(v) for k, v in step(
                None, draws=tuple(d.to(dev) for d in draws)).items()}
            grads = _grads(m)
            out[dev] = (metrics, before, grads)
        (mg, bg, gg), (mc, bc, gc) = out["cuda"], out["cpu"]
        res[name] = {"metrics": max(abs(mg[k] - mc[k]) / abs(mc[k])
                                    for k in mc),
                     "outputs": float((bg - bc).abs().max()
                                      / bc.abs().max()),
                     "grad_rel_l2": _rel_l2(gg, gc)}
        if res[name]["metrics"] > AFFINE_TOL["loss"] or \
                res[name]["outputs"] > AFFINE_TOL["outputs"] or \
                res[name]["grad_rel_l2"] > AFFINE_TOL["grad_rel_l2"]:
            raise AssertionError(f"affine reference ({name}): {res[name]} "
                                 f"against {AFFINE_TOL}")
    print(f"affine reference: card vs CPU {json.dumps(res)} (limits "
          f"{AFFINE_TOL}) on {card}", flush=True)
    return res


def _time_scatter_at(ks, knn_cuda, b, n, k, c, seed, what,
                     dtype=torch.float32):
    """The transpose, K3 (payload `dtype`) and K4 at a train step's shape
    (b, n, k, c) on a K1 graph of random points, which phase 6 does not
    time: each against its plain version (the transpose bit for bit), as
    `_time_dpsr_scatter` times DPSR-Net's."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    idx3, _ = knn_cuda(torch.rand((b, n, 3), generator=g, device=dev) * 2
                       - 1, k, True)
    idx3 = idx3.contiguous()
    idx2 = idx3.reshape(b, n * k)
    tr = ks.transpose(idx2, n)
    if not all(torch.equal(a, w) for a, w in
               zip(tr, ks.transpose_plain(idx2, n))):
        raise AssertionError(f"transpose {what} {b}x{n * k}_rows{n}: "
                             "kernel != plain")
    kstar = torch.randint(0, k, (b, n, c), generator=g, device=dev,
                          dtype=torch.int32)
    s_ = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    p_ = torch.randn((b, n, c), generator=g, device=dev).to(dtype)
    err3 = _check_routed(ks, idx3, kstar, s_, p_, n, tr)
    err4 = _check_count(ks, idx2, n, tr)
    b3, by3 = bound_ms(idx3.numel() * 4 + b * n * c * 4
                       + 2 * s_.numel() * s_.element_size()
                       + b * n * 2 * c * 4, 2 * idx3.numel() * c)
    b4, by4 = bound_ms(b * n * 8 + 4, b * n)
    bt, byt = bound_ms(idx2.numel() * 8 + (b * n + 1) * 4, 0)
    ptr = tr[1]
    out = {
        "transpose": {
            "call": f"{b}x{n * k}_rows{n}", "max_abs_err": 0.0,
            "ms": median_ms(lambda: ks.transpose(idx2, n)),
            "plain_ms": median_ms(lambda: ks.transpose_plain(idx2, n)),
            "bound_ms": bt, "bound_by": byt, "library_ms": None},
        "scatter_routed": {
            "call": f"{b}x{n}x{k}x{c}_{str(dtype)[6:]}",
            "max_abs_err": err3,
            "ms": median_ms(lambda: ks.scatter_routed(idx3, kstar, s_, p_,
                                                      n)),
            "shared_ms": median_ms(lambda: ks.scatter_routed(
                idx3, kstar, s_, p_, n, tr)),
            "plain_ms": median_ms(lambda: ks.scatter_routed_plain(
                idx3, kstar, s_, p_, n)),
            "bound_ms": b3, "bound_by": by3, "library_ms": None},
        "scatter_count": {
            "call": f"ptr_{b}x{n}", "max_abs_err": err4,
            "ms": median_ms(lambda: ks.scatter_count(idx2, n, tr)),
            "device_ms": graph_ms(lambda: ks.scatter_count(idx2, n, tr)),
            "plain_ms": median_ms(lambda: ks.count_from_ptr_plain(ptr, b,
                                                                  n)),
            "bound_ms": b4, "bound_by": by4,
            "library_ms": median_ms(lambda: torch.diff(ptr))}}
    print(f"{what} scatter timings ({b}x{n}, k={k}, C={c}, "
          f"{str(dtype)[6:]}): transpose == plain; {json.dumps(out)}",
          flush=True)
    return out


# ---- the rest of serving: the bin kernel, segment_cases, the fast variant,
# the bf16 CNN, --knn_recall training (phases 41-44) ----------------------

APPROX_SOURCE = "fissure_segmentation_tpu_torch/kernels/csrc/approx_topk.cu"
# no TPU kernel: the JAX package's lax.approx_max_k / approx_min_k calls,
# which XLA lowers to its ApproxTopK (a PartialReduce) on the TPU
APPROX_REPLACES = "fissure_segmentation_tpu/keypoints/foerstner.py:109"
APPROX_ALSO = ["fissure_segmentation_tpu/keypoints/extraction.py:116",
               "fissure_segmentation_tpu/ops/knn.py:86",
               "fissure_segmentation_tpu/ops/knn.py:91"]
# the fused row selection: the approximate graphs' approx_min_k and the
# exact feature graph's lax.top_k
SELECT_REPLACES = "fissure_segmentation_tpu/ops/knn.py:86"
SELECT_ALSO = ["fissure_segmentation_tpu/ops/knn.py:91",
               "fissure_segmentation_tpu/ops/knn.py:111"]
N_PIPE = 8            # cases of a segment_cases batch (bench.py's NPIPE)
# the bf16 CNN card against CPU: within this many times the CPU's own bf16
# error (its bf16 softmax against its f32 one); phase_fast_serving says why
BF16_CNN_FACTOR = 4.0
# ... and the card's bf16 softmax at least this share of that error away
# from its own f32 one, so a CNN that ran in float32 fails
BF16_CNN_MIN_SHARE = 0.25
KNN09_ARGV = DEFAULT_ARGV + ["--knn_recall", "0.9", "--train_only"]


def _exact_share(got_vals, exact_vals, largest: bool) -> float:
    """The share of each row's exact top-k that a selection found, read
    from values: a selected value at or beyond the exact k-th counts
    (scores without ties at the cut)."""
    kth = exact_vals[..., -1:]
    hit = got_vals >= kth if largest else got_vals <= kth
    finite = torch.isfinite(exact_vals)
    hit = hit & torch.isfinite(got_vals)
    return float(hit.sum() / finite.sum().clamp(min=1))


def _bin_case(name, x, k, target, largest):
    """Phase 41 at one shape of the bin pass (k > 128), x in the shape its
    path selects over (its rank sets the bins): the kernel on x's rows
    against its plain version bit for bit, the whole selection against
    approx_top_k_plain, then the kernel's time cold (L2 flushed before
    each call: its 33-67 MB input is about the L2's size) and warm, median
    times of its plain version, the aggregation (two sorts), the whole
    selection and torch.topk's exact top-k, the bound (the kernel's
    bytes), and the share of the exact top-k found."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import (
        aggregate, bin_extrema, bin_extrema_plain)
    from fissure_segmentation_tpu_torch.ops.approx_topk import (
        approx_top_k, approx_top_k_plain, reduction_output_size)
    from fissure_segmentation_tpu_torch.prof.timing import cold_ms
    n = x.shape[-1]
    rows = x.numel() // n
    n_bins, r = reduction_output_size(n, x.ndim, k, target)
    red = 1 << r
    x2 = x.reshape(rows, n)
    vk, ik = bin_extrema(x2, n_bins, red, largest)
    torch.cuda.synchronize()
    vp, ip = bin_extrema_plain(x2, n_bins, red, largest)
    if not (torch.equal(vk, vp) and torch.equal(ik, ip)):
        raise AssertionError(f"bins {name}: kernel differs from plain "
                             f"({(ik != ip).sum().item()} winners)")
    sel = approx_top_k(x, k, target, largest)
    ref = approx_top_k_plain(x, k, target, largest)
    if not all(torch.equal(a, b) for a, b in zip(sel, ref)):
        raise AssertionError(f"bins {name}: selection differs from plain")
    exact = torch.topk(x.float(), k, dim=-1, largest=largest).values
    share = _exact_share(sel[0].float(), exact, largest)
    es = x.element_size()
    bound, by = bound_ms(rows * n * es + rows * n_bins * (es + 4), rows * n)
    t = {"rows": rows, "n": n, "k": k, "recall_target": target,
         "bins": n_bins, "reduction": red, "dtype": str(x.dtype)[6:],
         "call": f"{rows}x{n}_L{n_bins}_{str(x.dtype)[6:]}",
         "ms": cold_ms(lambda: bin_extrema(x2, n_bins, red, largest)),
         "warm_ms": median_ms(lambda: bin_extrema(x2, n_bins, red, largest)),
         "plain_ms": median_ms(lambda: bin_extrema_plain(x2, n_bins, red,
                                                         largest),
                               reps=3, inner=1, warm=1),
         "aggregate_ms": median_ms(lambda: aggregate(vk, ik, k, largest),
                                   reps=3, inner=3, warm=1),
         "selection_ms": median_ms(lambda: approx_top_k(x, k, target,
                                                        largest),
                                   reps=3, inner=3, warm=1),
         "library_ms": median_ms(lambda: torch.topk(x, k, dim=-1,
                                                    largest=largest),
                                 reps=3, inner=3, warm=1),
         "library": "torch.topk (exact)", "bound_ms": bound, "bound_by": by,
         "exact_share": share}
    print(f"bins {name}: ({rows}, {n}) -> {k} at {target}, L {n_bins} x "
          f"{red} {t['dtype']}: kernel == plain; kernel cold {t['ms']:.4f} "
          f"ms, warm {t['warm_ms']:.4f}, plain {t['plain_ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({by}); aggregation {t['aggregate_ms']:.4f} ms, "
          f"selection {t['selection_ms']:.4f} ms, torch.topk exact "
          f"{t['library_ms']:.4f} ms; exact share found {share:.4f}",
          flush=True)
    return t


def _select_case(name, x, k, target, largest, exact=False, timed=True):
    """Phase 41 at one shape of the fused row selection (k <= 128), x in
    the shape its path selects over: the kernel against its plain version
    bit for bit (indices, values with their own bits) and against the path
    it replaces: the bin pass and two sorts (PR 17's selection, also
    approx_top_k against approx_top_k_plain) or, with `exact` (the feature
    graph: one element a bin, int32 indices), the stable sort feature_knn
    ran. Where `timed`, median times of the kernel, its plain version, the
    replaced path and torch.topk's exact top-k, the bound (x read once, k
    values and indices a row written once) and the share of the exact
    top-k found."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import (
        aggregate, bin_extrema, select_rows, select_rows_plain)
    from fissure_segmentation_tpu_torch.ops.approx_topk import (
        approx_top_k, approx_top_k_plain, reduction_output_size)
    n = x.shape[-1]
    rows = x.numel() // n
    x2 = x.reshape(rows, n)
    if exact:
        n_bins, red, index = n, 1, torch.int32
    else:
        n_bins, r = reduction_output_size(n, x.ndim, k, target)
        red, index = 1 << r, torch.int64
    vk, ik = select_rows(x2, n_bins, red, k, largest, index_dtype=index)
    torch.cuda.synchronize()
    vp, ip = select_rows_plain(x2, n_bins, red, k, largest)

    def same(v, i):
        return (torch.equal(ik.long(), i.long()) and torch.equal(vk, v)
                and torch.equal(torch.signbit(vk), torch.signbit(v)))
    if not same(vp, ip):
        raise AssertionError(f"select {name}: kernel differs from plain "
                             f"({(ik.long() != ip).sum().item()} slots)")
    if exact:
        def old():
            return torch.sort(x2, dim=-1, descending=largest, stable=True)
        what = "stable sort"
        # -0.0 sorts as +0.0 (the distances hold none)
        si = torch.sort(x2 + 0.0, dim=-1, descending=largest,
                        stable=True)[1][:, :k]
        replaced = x2.gather(1, si), si
    else:
        def old():
            return aggregate(*bin_extrema(x2, n_bins, red, largest), k,
                             largest)
        what = "bin pass + two sorts"
        replaced = old()
        sel = approx_top_k(x, k, target, largest)
        ref = approx_top_k_plain(x, k, target, largest)
        if not all(torch.equal(a, b) for a, b in zip(sel, ref)):
            raise AssertionError(f"select {name}: approx_top_k differs "
                                 "from approx_top_k_plain")
    if not same(*replaced):
        raise AssertionError(f"select {name}: kernel differs from the "
                             f"{what} it replaces")
    if not timed:
        print(f"select {name}: ({rows}, {n}) -> {k}, L {n_bins} x {red} "
              f"{str(x.dtype)[6:]}: kernel == plain == {what}", flush=True)
        return None
    exact_vals = torch.topk(x2.float(), k, dim=-1, largest=largest).values
    share = _exact_share(vk.float(), exact_vals, largest)
    es = x.element_size()
    ib = 4 if exact else 8
    bound, by = bound_ms(rows * n * es + rows * k * (es + ib), rows * n)
    t = {"rows": rows, "n": n, "k": k, "recall_target": target,
         "bins": n_bins, "reduction": red, "dtype": str(x.dtype)[6:],
         "call": f"{rows}x{n}_L{n_bins}_k{k}_{str(x.dtype)[6:]}",
         "ms": median_ms(lambda: select_rows(x2, n_bins, red, k, largest,
                                             index_dtype=index)),
         "plain_ms": median_ms(lambda: select_rows_plain(
             x2, n_bins, red, k, largest), reps=3, inner=1, warm=1),
         "old_path": what,
         "old_path_ms": median_ms(old, reps=3, inner=3, warm=1),
         "library_ms": median_ms(lambda: torch.topk(x2, k, dim=-1,
                                                    largest=largest),
                                 reps=3, inner=3, warm=1),
         "library": "torch.topk (exact)", "bound_ms": bound, "bound_by": by,
         "exact_share": share}
    t["bound_share"] = bound / t["ms"]
    print(f"select {name}: ({rows}, {n}) -> {k} at {target}, L {n_bins} x "
          f"{red} {t['dtype']}: kernel == plain == {what}; kernel "
          f"{t['ms']:.4f} ms ({t['bound_share']:.2f} of the bound "
          f"{bound:.4f} ms, {by}), plain {t['plain_ms']:.4f} ms, {what} "
          f"{t['old_path_ms']:.4f} ms, torch.topk exact "
          f"{t['library_ms']:.4f} ms; exact share found {share:.4f}",
          flush=True)
    return t


def _tied_rows(rows, n, largest, dtype, g):
    """Integer scores full of ties, signed zeros, negative values and a
    quarter masked at -inf (+inf for the minimum)."""
    x = torch.randint(-10, 11, (rows, n), generator=g, device="cuda").float()
    zero = x == 0
    x[zero] = torch.where(torch.rand(int(zero.sum()), generator=g,
                                     device="cuda") < 0.5, -0.0, 0.0)
    x[torch.rand((rows, n), generator=g, device="cuda") < 0.25] = \
        -torch.inf if largest else torch.inf
    return x.to(dtype)


def _detector_scores(vol, mask):
    """The Förstner detector's masked score volume (serving's arguments:
    sigma 0.5, NMS d = 5, threshold 1e-8), flat (1-D, as the detector
    selects over it)."""
    from fissure_segmentation_tpu_torch.keypoints.foerstner import (
        distinctiveness, erode_mask)
    from fissure_segmentation_tpu_torch.utils.filters import max_pool_same
    dist = distinctiveness(vol, 0.5)
    is_kpt = erode_mask(mask) & (max_pool_same(dist, 5) == dist) & \
        (dist >= 1e-8)
    return torch.where(is_kpt, dist, -torch.inf).reshape(-1)


def phase_approx_topk(card: str):
    """Phase 41: the approximate top-k's kernels against their plain
    versions at the paths' shapes. The bin pass (k > 128): (1, 256^3) ->
    20 000 at recall 0.95 (uniform scores in f32 and bf16, and the
    Förstner detector's masked score volume of the shared case). The fused
    row selection (k <= 128): the kNN rows (32 * 2048, 2048) -> 40 at 0.9
    (the coordinate graph's f32 distances with the diagonal at +inf; the
    bf16 feature graph's at (32, 2048, 64) with the diagonal at -1), the
    fast-serving static graph's (5 * 2048, 2048) rows in f32 (the path's)
    and bf16, the exact feature graph (the bf16 distances of (32, 2048, 64)
    features, diagonal 0) at kk = 40 (the default run's) and 41 against
    the stable sort, and rows full of ties with signed zeros and masked
    +-inf in both dtypes and directions. Returns (the bin pass's timings,
    the selection's timings), by name."""
    from fissure_segmentation_tpu_torch.ops.knn import pairwise_sqdist
    g = torch.Generator(device="cuda").manual_seed(41)
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    uni = torch.rand((int(np.prod(SHAPE)),), generator=g, device="cuda")
    bins = {name: _bin_case(name, *args) for name, args in {
        "detector_uniform_f32": (uni, 20_000, 0.95, True),
        "detector_uniform_bf16": (uni.to(torch.bfloat16), 20_000, 0.95,
                                  True),
        "detector_foerstner_f32": (_detector_scores(vol, mask), 20_000,
                                   0.95, True)}.items()}
    del uni
    pts = torch.rand((32, 2048, 3), generator=g, device="cuda")
    d = pairwise_sqdist(pts, pts)
    d.diagonal(dim1=-2, dim2=-1).fill_(torch.inf)
    feats = torch.randn((32, 2048, 64), generator=g, device="cuda").to(
        torch.bfloat16)
    fd = pairwise_sqdist(feats, feats)
    fd.diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    sel = {name: _select_case(name, *args) for name, args in {
        "knn_rows_f32": (d, 40, 0.9, False),
        "knn_rows_bf16": (fd, 40, 0.9, False),
        "fast_static_f32": (d[:5], 40, 0.9, False),
        "fast_static_bf16": (d[:5].to(torch.bfloat16), 40, 0.9, False)}
        .items()}
    del d, fd
    exact = pairwise_sqdist(feats)
    for kk in (40, 41):
        sel[f"feature_graph_bf16_k{kk}"] = _select_case(
            f"feature_graph_bf16_k{kk}", exact, kk, None, False, exact=True)
    del exact
    for dt in (torch.float32, torch.bfloat16):
        for largest in (True, False):
            x = _tied_rows(4096, 2048, largest, dt, g)
            for k in (1, 40, 41, 128):
                _select_case(f"ties_{str(dt)[6:]}_{largest}_k{k}", x, k, 0.9,
                             largest, timed=False)
            _select_case(f"ties_{str(dt)[6:]}_{largest}_exact", x, 41, None,
                         largest, exact=True, timed=False)
    torch.cuda.empty_cache()
    print(json.dumps({"approx_topk_bins": bins, "approx_topk_select": sel,
                      "card": card}), flush=True)
    return bins, sel


def _sync_sites(fn):
    """Run fn with torch.cuda.set_sync_debug_mode("warn"); returns (its
    output, {the innermost line of the port on the stack at each host
    synchronisation: count}). A `.item()` after fn is the positive control:
    the mode must see it."""
    import traceback
    import warnings
    sites = {}
    port = os.sep + "fissure_segmentation_tpu_torch" + os.sep

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        here = [f for f in stack if port in f.filename]
        at = (f"{here[-1].filename.split(port)[-1]}:{here[-1].lineno}"
              if here else " < ".join(
                  f"{os.path.basename(f.filename)}:{f.lineno}"
                  for f in stack[::-1][:4]))
        sites[at] = sites.get(at, 0) + 1
    torch.cuda.synchronize()
    # setting the mode warns of itself; that warning is not recorded
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            out = fn()
            found = dict(sites)
            torch.zeros(1, device="cuda").item()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if sum(sites.values()) == sum(found.values()):
        raise AssertionError("sync debug mode did not see .item()")
    return out, found


def _same_results(a, b) -> bool:
    """Bit for bit: keypoints, labels, every triangle, the labelmap."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if not (np.array_equal(x.kpts, y.kpts)
                and np.array_equal(x.labels, y.labels)
                and np.array_equal(x.labelmap, y.labelmap)):
            return False
        for (t1, v1), (t2, v2) in zip(x.meshes, y.meshes):
            if not (np.array_equal(t1, t2) and np.array_equal(v1, v2)):
                return False
    return True


def _serve_batch(vol, mask, apply, seed, pipelined, n=N_PIPE, **kw):
    """n cases of the shared volume: segment_cases, or a loop of
    segment_case with the same per-case generators; (results, s/case,
    timings)."""
    from fissure_segmentation_tpu_torch.serving import (case_generator,
                                                        segment_case,
                                                        segment_cases)
    torch.cuda.synchronize()
    tm = []
    t0 = time.perf_counter()
    if pipelined:
        res = segment_cases([vol] * n, [mask] * n, apply, seed=seed,
                            timings=tm, center_x=SHAPE[2] / 2, **kw)
    else:
        res = [segment_case(vol, mask, apply, case_generator(seed, i),
                            center_x=SHAPE[2] / 2, **kw)
               for i in range(n)]
    return res, (time.perf_counter() - t0) / n, tm


def _serve_ab(vol, mask, apply, what, card, **kw) -> dict:
    """Serial loop and segment_cases in turns (serial, pipelined,
    pipelined, serial), each N_PIPE cases of seed 0: every run bit-equal to
    the first serial one; s/case and cases/s of each, the stage medians of
    the pipelined runs, and the busy share of one more run of each."""
    runs, tms = {"serial": [], "pipelined": []}, []
    first = None
    for mode in ("serial", "pipelined", "pipelined", "serial"):
        res, s, tm = _serve_batch(vol, mask, apply, 0, mode == "pipelined",
                                  **kw)
        for r in res:
            check_result(r, SHAPE, f"{what} {mode}")
        if first is None:
            first = res
        elif not _same_results(res, first):
            raise AssertionError(f"{what}: {mode} results differ from the "
                                 "serial loop's")
        runs[mode].append(s)
        tms += tm
    out = {m: {"s_per_case": statistics.median(v), "runs": v,
               "cases_per_s": 1 / statistics.median(v)}
           for m, v in runs.items()}
    out["stage_ms_median"] = {
        k: 1e3 * statistics.median([t[k] for t in tms]) for k in
        ("dispatch_s", "fetch_s", "host_s")}
    for mode in ("serial", "pipelined"):
        out[mode]["busy_share"] = _profiled_busy(
            lambda: _serve_batch(vol, mask, apply, 1, mode == "pipelined",
                                 **kw), steps=1)
    out["device_ms_per_case"] = (1e3 * out["pipelined"]["s_per_case"]
                                 * out["pipelined"]["busy_share"])
    print(f"{what}: {N_PIPE} cases, serial {out['serial']['s_per_case']:.4f}"
          f" s/case (busy {out['serial']['busy_share']:.3f}), segment_cases "
          f"{out['pipelined']['s_per_case']:.4f} s/case "
          f"({out['pipelined']['cases_per_s']:.2f} cases/s, busy "
          f"{out['pipelined']['busy_share']:.3f}), stage medians "
          f"{ {k: round(v, 2) for k, v in out['stage_ms_median'].items()} } "
          f"ms; results bit-equal to the serial loop in every run, on "
          f"{card}", flush=True)
    return out


def _serving_model(case, **kw):
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    model = DGCNNSeg(k=40, in_features=3, num_classes=4, dynamic=False,
                     generator=torch.Generator().manual_seed(0),
                     **kw).cuda().eval()
    return biased_model(model, case, SHAPE)


def phase_pipeline(ks, knn_cuda, card: str):
    """Phase 42: segment_cases against a serial loop of segment_case on
    N_PIPE copies of the shared 256^3 case (Förstner, default widths, phase
    4's model): the host synchronisations left in one case's device half
    (torch.cuda.set_sync_debug_mode), then _serve_ab. Counts are reset
    before the first pipelined run and read after it; returns (counts, the
    gather-reduce's calls, timing)."""
    from fissure_segmentation_tpu_torch.serving import (_dispatch_case,
                                                        _fetch_case,
                                                        case_generator)
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    apply = _serving_model(case)
    _serve_batch(vol, mask, apply, 5, True, n=3)         # warm-up
    d, sites = _sync_sites(lambda: _dispatch_case(vol, mask, apply,
                                                  case_generator(0, 0)))
    _fetch_case(d)
    print(f"pipeline: host synchronisations in one case's device half: "
          f"{sites or 'none'}", flush=True)
    _reset(ks, knn_cuda)
    res, s, _ = _serve_batch(vol, mask, apply, 0, True)
    counts = _counts(ks, knn_cuda)
    gr = _gr_calls(ks, knn_cuda)
    for name, n in (("knn", 11), ("gather_reduce", 20)):
        if counts[name] < n * N_PIPE:
            raise AssertionError(f"pipeline: {name} launched {counts[name]}"
                                 f" times in {N_PIPE} cases")
    timing = _serve_ab(vol, mask, apply, "pipeline", card)
    timing["sync_sites"] = sites
    timing["splat_scatter"] = _splat_scatter_ms(card)
    return counts, gr, timing


def _splat_scatter_ms(card: str) -> dict:
    """The scatter of serving's PSR splat (ops/splat.py) at its call's
    shape, 3 clouds of 8 x 8192 corner contributions of 3 features into
    3 x 64^3 cells (random cells): median ms of the sorted index_put_ the
    path runs (deterministic) and of index_add_ (float atomics)."""
    g = torch.Generator(device="cuda").manual_seed(42)
    cells = 64 ** 3
    flat = (torch.randint(0, cells, (3, 8 * 8192), generator=g,
                          device="cuda")
            + cells * torch.arange(3, device="cuda")[:, None]).reshape(-1)
    pay = torch.randn((flat.numel(), 3), generator=g, device="cuda")
    out = torch.zeros((3 * cells, 3), device="cuda")
    t = {"index_put_sorted_ms": median_ms(
            lambda: out.zero_().index_put_((flat,), pay, accumulate=True)),
         "index_add_ms": median_ms(
            lambda: out.zero_().index_add_(0, flat, pay))}
    print(f"pipeline: the splat's scatter (3 x 65 536 -> 3 x 64^3 cells, "
          f"3 features, zeroing included): sorted index_put_ "
          f"{t['index_put_sorted_ms']:.4f} ms, index_add_ "
          f"{t['index_add_ms']:.4f} ms on {card}", flush=True)
    return t


def _graph_recall(x, k, self_loop, target, exact_fn) -> float:
    from fissure_segmentation_tpu_torch.ops.knn import knn
    got = knn(x, k, self_loop=self_loop, recall_target=target)
    want = exact_fn()
    hit = (got[..., :, None] == want[..., None, :]).any(-1)
    return float(hit.float().mean())


def _cnn_pair(dev_fn, cpu_fn, what: str) -> dict:
    """The bf16 CNN's softmax card against CPU: within BF16_CNN_FACTOR x
    the CPU's own bf16 error, at least BF16_CNN_MIN_SHARE x that error away
    from the card's own f32 softmax (so the card ran in bf16), argmax
    equal but where the CPU's bf16 top-two margin is under the
    tolerance."""
    card16, card32 = dev_fn(torch.bfloat16).cpu(), dev_fn(None).cpu()
    cpu16, cpu32 = cpu_fn(torch.bfloat16), cpu_fn(None)
    own = (cpu16 - cpu32).abs().max().item()
    err = (card16 - cpu16).abs().max().item()
    card_own = (card16 - card32).abs().max().item()
    tol = BF16_CNN_FACTOR * own
    if not (own > 0 and err <= tol):
        raise AssertionError(f"{what}: bf16 card against CPU {err:.3g} > "
                             f"{BF16_CNN_FACTOR} x the CPU's bf16 error "
                             f"{own:.3g}")
    if card_own < BF16_CNN_MIN_SHARE * own:
        raise AssertionError(f"{what}: the card's bf16 softmax is "
                             f"{card_own:.3g} from its f32 one, under "
                             f"{BF16_CNN_MIN_SHARE} x the CPU's bf16 error "
                             f"{own:.3g}: it did not run in bf16")
    top2 = cpu16.topk(2, dim=-1).values
    flipped = card16.argmax(-1) != cpu16.argmax(-1)
    if (flipped & (top2[..., 0] - top2[..., 1] >= tol)).any():
        raise AssertionError(f"{what}: argmax differs at a clear margin")
    print(f"{what}: bf16 softmax card against CPU {err:.3g} (the CPU's "
          f"bf16 error {own:.3g}, tolerance {tol:.3g}; card bf16 against "
          f"card f32 {card_own:.3g}); argmax flips {int(flipped.sum())}",
          flush=True)
    return {"max_abs_err": err, "cpu_bf16_err": own,
            "card_bf16_err": card_own, "flips": int(flipped.sum())}


def phase_fast_serving(ks, knn_cuda, card: str):
    """Phase 43: the fast variant served (DGCNNSeg bf16 with knn_recall =
    0.9, the approximate Förstner selection) on the shared 256^3 case,
    serial and pipelined (_serve_ab), counts reset before and read after;
    the detector's share of the exact keypoints at recall 0.95 and the kNN
    graphs' at 0.9 ((32, 2048, 3) f32, (32, 2048, 64) bf16 features); the
    bf16 CNN in kp_mode="cnn" (float32 and bfloat16, one warm-up and 3
    timed cases each, and one case with approx_top_k), the sliding window
    at 256^3 in both dtypes, and both CNN protocols card against CPU in
    bf16 on phase 15's small input, held within BF16_CNN_FACTOR x the
    CPU's own bf16 error (the card and the CPU round each layer's bf16
    output after float32 sums in other orders, an error of the bf16
    error's own size; 4 leaves a margin). Returns (counts, gather-reduce
    calls, the bin pass's and the fused row selection's calls, timing)."""
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.kernels.approx_topk import (
        bin_extrema, select_rows)
    from fissure_segmentation_tpu_torch.keypoints.foerstner import \
        foerstner_keypoints
    from fissure_segmentation_tpu_torch.models import (predict_all_patches,
                                                       predict_full_volume)
    from fissure_segmentation_tpu_torch.ops.knn import feature_knn, knn
    from fissure_segmentation_tpu_torch.serving import segment_case
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    fast = _serving_model(case, dtype=torch.bfloat16, knn_recall=0.9)
    timing = {"substep_s": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        timing["substep_s"][name] = now - clock[0]
        clock[0] = now
    _serve_batch(vol, mask, fast, 5, True, n=3,
                 approx_top_k=True)                     # warm-up
    _reset(ks, knn_cuda)
    _serve_batch(vol, mask, fast, 0, True, approx_top_k=True)
    counts = _counts(ks, knn_cuda)
    gr = _gr_calls(ks, knn_cuda)
    bins = (dict(bin_extrema.calls), dict(select_rows.calls))
    # a case: the detector's selection on the bin pass, the ensemble's ten
    # static graphs on the fused row selection
    for name, n in (("bin_extrema", 1), ("select_rows", 10)):
        if counts[name] < n * N_PIPE:
            raise AssertionError(f"fast serving: {name} launched "
                                 f"{counts[name]} times in {N_PIPE} cases; "
                                 f"the path needs >= {n} a case")
    timing["serving"] = _serve_ab(vol, mask, fast, "fast serving", card,
                                  approx_top_k=True)
    lap("serving")

    kw = dict(sigma=0.5, d=5, thresh=1e-8, max_kpts=20_000)
    ka, va, n_det = foerstner_keypoints(vol, mask, approx_top_k=True, **kw)
    ke, ve, _ = foerstner_keypoints(vol, mask, **kw)
    found = {tuple(r) for r in ka[va].tolist()}
    exact = {tuple(r) for r in ke[ve].tolist()}
    g = torch.Generator(device="cuda").manual_seed(43)
    pts = torch.rand((32, 2048, 3), generator=g, device="cuda")
    feats = torch.randn((32, 2048, 64), generator=g, device="cuda").to(
        torch.bfloat16)
    timing["recall"] = {
        "detector_256cube_r095": len(found & exact) / max(len(exact), 1),
        "detections": int(n_det), "exact_valid": len(exact),
        "coords_32x2048x3_f32_r09": _graph_recall(
            pts, 40, False, 0.9, lambda: knn(pts, 40, self_loop=False)),
        "features_32x2048x64_bf16_r09": _graph_recall(
            feats, 40, True, 0.9, lambda: feature_knn(feats, 40)[0])}
    print(f"fast serving: shares of the exact selection found "
          f"{timing['recall']}", flush=True)
    lap("recall")

    from fissure_segmentation_tpu_torch.kernels.depthwise import \
        depthwise_conv3_cuda
    cnn = _cnn_model(0).cuda()
    apply = _serving_model(case)
    for name, kwc in (("cnn_f32", {}),
                      ("cnn_bf16", {"cnn_dtype": torch.bfloat16})):
        segment_case(vol, mask, apply, torch.Generator().manual_seed(1),
                     kp_mode="cnn", cnn_model=cnn, center_x=SHAPE[2] / 2,
                     **kwc)
        _zero(depthwise_conv3_cuda)
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = segment_case(vol, mask, apply,
                               torch.Generator().manual_seed(2 + i),
                               kp_mode="cnn", cnn_model=cnn,
                               center_x=SHAPE[2] / 2, **kwc)
            times.append(time.perf_counter() - t0)
            check_result(res, SHAPE, f"{name} case {i}")
        roles = dict(depthwise_conv3_cuda.roles)
        if roles["forward"] < 3 or roles["stride2"] < 3:
            raise AssertionError(f"{name}: K6 launched {roles} in 3 cases")
        timing[name] = {"s_per_case": statistics.median(times),
                        "cases_s": times, "k6_launches": roles}
    before = bin_extrema.launches
    res = segment_case(vol, mask, apply, torch.Generator().manual_seed(9),
                       kp_mode="cnn", cnn_model=cnn, cnn_dtype=torch.bfloat16,
                       approx_top_k=True, center_x=SHAPE[2] / 2)
    check_result(res, SHAPE, "cnn bf16 approx case")
    if bin_extrema.launches - before != 1:
        raise AssertionError("cnn approx case: the bin pass did not "
                             "select its keypoints")
    lap("cnn_mode")
    for dt in (None, torch.bfloat16):
        name = "bf16" if dt else "f32"
        timing[f"full_volume_{name}_ms"] = median_ms(
            lambda: predict_full_volume(cnn, vol, dtype=dt), reps=3,
            inner=1, warm=1)
        timing[f"all_patches_{name}_ms"] = median_ms(
            lambda: predict_all_patches(cnn, vol, 4, dtype=dt), reps=1,
            inner=1, warm=0)
    lap("cnn_protocols_256")
    small = make_synthetic_image_case(2, shape=(40, 48, 56))
    img = torch.from_numpy(small["image"])
    cnn_cpu = copy.deepcopy(cnn).cpu()
    timing["cnn_reference"] = {
        "full_volume": _cnn_pair(
            lambda dt: predict_full_volume(cnn, img.cuda(), dtype=dt),
            lambda dt: predict_full_volume(cnn_cpu, img, dtype=dt),
            "cnn bf16 full volume"),
        "all_patches": _cnn_pair(
            lambda dt: predict_all_patches(cnn, img.cuda(), 4,
                                           patch_size=(32, 32, 32),
                                           dtype=dt),
            lambda dt: predict_all_patches(cnn_cpu, img, 4,
                                           patch_size=(32, 32, 32),
                                           dtype=dt),
            "cnn bf16 sliding window")}
    lap("cnn_reference")
    print(f"fast serving: cnn mode f32 {timing['cnn_f32']['s_per_case']:.4f}"
          f" s/case, bf16 {timing['cnn_bf16']['s_per_case']:.4f} s/case; "
          f"whole volume f32 {timing['full_volume_f32_ms']:.2f} ms, bf16 "
          f"{timing['full_volume_bf16_ms']:.2f} ms; sliding window f32 "
          f"{timing['all_patches_f32_ms']:.1f} ms, bf16 "
          f"{timing['all_patches_bf16_ms']:.1f} ms on {card}", flush=True)
    return counts, gr, bins, timing


def phase_knn_recall_train(ks, knn_cuda, card: str):
    """Phase 44: train_point_seg --knn_recall 0.9 (the default run's
    dynamic bf16 DGCNNSeg, 32 x 2048, 3 epochs of fold 0, --train_only);
    model.pt keeps knn_recall; then 10 timed warm steps with and without
    knn_recall, dynamic and static (the canonical CV's graph), bf16; then
    time_keypoint_extraction on 2 copies of the shared 256^3 case. Counts
    reset before the entry run and read after it; returns (counts,
    gather-reduce calls, K4 calls, the fused row selection's calls,
    timing)."""
    from fissure_segmentation_tpu_torch import (time_keypoint_extraction,
                                                train_point_seg)
    from fissure_segmentation_tpu_torch.kernels.approx_topk import \
        select_rows
    from fissure_segmentation_tpu_torch.models import load_fold_model
    from fissure_segmentation_tpu_torch.train.profile_step import (
        canonical_data, make_step)
    os.environ.pop("FSEG_FUSED_EDGE", None)
    timing = {}
    _reset(ks, knn_cuda)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        if train_point_seg.main(KNN09_ARGV + ["--output", tmp]) != 0:
            raise AssertionError("knn09 run: the entry point failed")
        timing["train_s"] = time.perf_counter() - t0
        fold = os.path.join(tmp, "fold0")
        hist = _read_history(os.path.join(fold, "history.csv"))
        model = load_fold_model(fold)
        if len(hist) != 3 or not np.isfinite(hist).all() or \
                model.knn_recall != 0.9 or not model.dynamic:
            raise AssertionError(f"knn09 run: history {hist}, model.pt "
                                 f"{model.config}")
        counts = _counts(ks, knn_cuda)
        gr, k4 = _gr_calls(ks, knn_cuda), _check_k4_route(ks, "knn09 run")
        bins = dict(select_rows.calls)
        for name in ("select_rows", "transpose", "scatter_rows",
                     "scatter_routed", "scatter_count", "gather_reduce"):
            if counts[name] < 1:
                raise AssertionError(f"knn09 run: {name} never launched")
        timing["loss_history"] = hist
        print(f"knn09 run: 3 epochs of fold 0 in {timing['train_s']:.1f} s;"
              f" loss history {hist}; launches {counts}", flush=True)
        ds, loss_fn = canonical_data()
        for name, kw in (("dynamic", dict(dynamic=True)),
                         ("dynamic_knn09", dict(dynamic=True,
                                                knn_recall=0.9)),
                         ("static", {}), ("static_knn09",
                                          dict(knn_recall=0.9))):
            step = make_step(ds, loss_fn, tmp, dtype=torch.bfloat16, **kw)
            timing[name] = _timed_steps(ks, knn_cuda, step, name)
        print(f"knn09 run: bf16 steps "
              f"{ {k: round(timing[k]['ms_per_step'], 2) for k in ('dynamic', 'dynamic_knn09', 'static', 'static_knn09')} }"
              f" ms on {card}", flush=True)

        data = os.path.join(tmp, "cases")
        os.makedirs(data)
        ct = _synthetic_ct_once()
        for i in range(2):
            np.savez(os.path.join(data, f"synthetic{i}_img_fixed.npz"),
                     image=ct["image"], lung_mask=ct["lung_mask"])
        out = os.path.join(tmp, "preproc_timing")
        if time_keypoint_extraction.main(["--data_dir", data, "--output",
                                          out]) != 0:
            raise AssertionError("time_keypoint_extraction failed")
        timing["keypoint_timing"] = {
            f: _csv(os.path.join(out, f)) for f in sorted(os.listdir(out))}
        if len(timing["keypoint_timing"]) != 6:
            raise AssertionError(f"time_keypoint_extraction wrote "
                                 f"{sorted(timing['keypoint_timing'])}")
    print(f"time_keypoint_extraction (2 cases of {SHAPE}): "
          f"{timing['keypoint_timing']} on {card}", flush=True)
    return counts, gr, k4, bins, timing


def _select_by_call(calls: dict, timed: dict) -> dict:
    """The fused row selection's main-path launches by call, each with phase
    41's times where it times that call, else timed on inputs of its shape:
    at one element a bin (the exact feature graph) the distances of random
    features, else random distances of (B, N, N) kNN rows at recall 0.9."""
    from fissure_segmentation_tpu_torch.ops.approx_topk import \
        reduction_output_size
    from fissure_segmentation_tpu_torch.ops.knn import pairwise_sqdist
    by_key = {t["call"]: t for t in timed.values()}
    out = {}
    for key, n in sorted(calls.items()):
        if key not in by_key:
            shape, lpart, kpart, dt = key.split("_")
            rows, width = (int(v) for v in shape.split("x"))
            n_bins, k, dt = int(lpart[1:]), int(kpart[1:]), getattr(torch, dt)
            if rows % width or (n_bins != width and reduction_output_size(
                    width, 3, k, 0.9)[0] != n_bins):
                raise AssertionError(f"select: call {key} of no known path")
            b = rows // width
            if n_bins == width:
                x = pairwise_sqdist(torch.randn((b, width, 64),
                                                device="cuda").to(dt))
                by_key[key] = _select_case(key, x, k, None, False,
                                           exact=True)
            else:
                x = torch.rand((b, width, width), device="cuda").to(dt)
                by_key[key] = _select_case(key, x, k, 0.9, False)
            del x
        t = by_key[key]
        out[key] = {"launches": n, **{f: t[f] for f in (
            "call", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "old_path_ms")}}
    return out


def _bins_by_call(calls: dict, timed: dict) -> dict:
    """The bin kernel's main-path launches by call, each with phase 41's
    times where it times that call, else timed on random scores of its
    shape."""
    from fissure_segmentation_tpu_torch.ops.approx_topk import \
        reduction_output_size
    by_key = {t["call"]: t for t in timed.values()}
    out = {}
    for key, n in sorted(calls.items()):
        if key not in by_key:
            shape, rest = key.split("_", 1)
            rows, width = (int(v) for v in shape.split("x"))
            dt = getattr(torch, rest.split("_")[1])
            # the detector's flat score volume, or the kNN's (B, N, N)
            # distances
            shape, k, target, largest = (
                ((width,), 20_000, 0.95, True) if rows == 1
                else ((rows // width, width, width), 40, 0.9, False))
            if rows % width and rows != 1 or reduction_output_size(
                    width, len(shape), k, target)[0] != int(
                        rest.split("_")[0][1:]):
                raise AssertionError(f"bins: call {key} of no known path")
            x = torch.rand(shape, device="cuda").to(dt)
            by_key[key] = _bin_case(key, x, k, target, largest)
        t = by_key[key]
        out[key] = {"launches": n, **{f: t[f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "aggregate_ms", "selection_ms")}}
    return out


# ---- the shape models and the scripts downstream of preprocessing
# (phases 45-48) -------------------------------------------------------------

CORR_CASES = 8            # synthetic 256^3 cases of the correspondences
CORR_POINTS = 4096        # points drawn from each fissure label's voxels
CORR_ITERS = 60           # rigid_iters = deform_iters, the entry's defaults
# the kmeans mode on the first 2 cases: its host k-means over every moved
# cloud (8 x 4096 points an object, 256 centres, 20 Lloyd rounds) and the
# registrations of 7 cases would take about 40 s (3 cases took 15.5 s on
# the H100's host); the cut is the number of cases, not a width
CORR_KMEANS_CASES = 2
# the card-vs-CPU reference: the first 3 cases at 256 points an object and
# 32 correspondences (the CPU takes seconds an E-step at 4096);
# phase_correspondences says why these limits
CORR_REF = {"cases": 3, "points": 256, "n_per_object": 32}
CORR_TOL = {"rotation": 1e-3, "translation": 1e-2, "scale": 1e-4,
            "share": 0.9, "near": 1e-2, "mean_rtol": 0.05}
# kernels/csrc/knn.cu stages KNN_SMEM_CLOUD = 192 KiB of cloud a block,
# 16 384 xyz points; larger clouds take its tiled branch
K1_STAGED_POINTS = 16384
REG_LANDMARKS = 200
REG_REF_SHAPE = (64, 64, 64)
# phase_register says why
REG_TOL = {"first_loss": 1e-4, "final_loss": 1e-3, "disp": 5e-2}
EB_REF_SHAPE = (64, 64, 64)
EB_TOL = 1e-3              # ASSD family, card against CPU (phase_baselines)


@functools.lru_cache(maxsize=1)
def _second_ct() -> dict:
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    return make_synthetic_image_case(1, shape=SHAPE)


def _ct(seed: int) -> dict:
    """`make_synthetic_image_case(seed, shape=SHAPE)`; seeds 0 and 1 made
    once (phases 45-48 share them), read-only."""
    if seed == 0:
        return _synthetic_ct_once()
    if seed == 1:
        return _second_ct()
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    return make_synthetic_image_case(seed, shape=SHAPE)


def _similarity(seed: int):
    """A seeded similarity (rotation by 0.1 rad about a random axis, scale
    within 5 %, translation within 8 voxels): how a case lies in its own
    scan. Returns (R, s, t) for p -> (p - c) @ R^T * s + c + t."""
    rng = np.random.default_rng(1000 + seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    r = np.eye(3) + np.sin(0.1) * k + (1 - np.cos(0.1)) * (k @ k)
    return r, 1 + rng.uniform(-0.05, 0.05), rng.uniform(-8, 8, 3)


def _case_objects(seed: int) -> list:
    """Case `seed`'s three fissure objects: CORR_POINTS voxels of each label
    drawn by a numpy generator seeded `seed`, world xyz; every case but the
    first moved by `_similarity(seed)` about the volume's centre."""
    labels = _ct(seed)["labels"]
    rng = np.random.default_rng(seed)
    objs = []
    for lbl in (1, 2, 3):
        vox = np.argwhere(labels == lbl)[:, ::-1].astype(np.float32)
        objs.append(vox[rng.choice(len(vox), CORR_POINTS, replace=False)])
    if seed:
        r, s, t = _similarity(seed)
        c = (np.asarray(SHAPE[::-1], np.float64) - 1) / 2
        objs = [((o - c) @ r.T * s + c + t).astype(np.float32)
                for o in objs]
    return objs


def _check_correspondences(out, n_cases: int, what: str) -> dict:
    """The fixed case's transform is the identity; finite points of the
    right shape; the mean distance between corresponding points of a
    moving case and the fixed case, in the fixed frame, is below the same
    points' distance before registration (in the case's own frame, the
    similarity undone). Returns both means."""
    corr, labels, transforms = out
    if corr.shape != (n_cases, 3 * 256, 3) or not np.isfinite(corr).all():
        raise AssertionError(f"{what}: correspondences {corr.shape}")
    if sorted(set(labels.tolist())) != [1, 2, 3]:
        raise AssertionError(f"{what}: labels {set(labels.tolist())}")
    t0 = transforms[0]
    if not (np.array_equal(t0["rotation"], np.eye(3))
            and not np.any(t0["translation"]) and t0["scale"] == 1.0):
        raise AssertionError(f"{what}: the fixed case's transform {t0}")
    after, before = [], []
    for c in range(1, n_cases):
        tr = transforms[c]
        raw = ((corr[c] - tr["translation"]) / tr["scale"]) \
            @ tr["rotation"].T
        after.append(float(np.linalg.norm(corr[c] - corr[0], axis=1).mean()))
        before.append(float(np.linalg.norm(raw - corr[0], axis=1).mean()))
    if not np.mean(after) < np.mean(before):
        raise AssertionError(f"{what}: {np.mean(after)} voxels between "
                             f"cases after registration, {np.mean(before)} "
                             "before")
    return {"mean_dist_after": float(np.mean(after)),
            "mean_dist_before": float(np.mean(before))}


def phase_correspondences(ks, knn_cuda, card: str):
    """Corresponding points at full width (`generate_corresponding_points`,
    the defaults: 60 rigid and 60 deformable CPD iterations, 256 points an
    object) over CORR_CASES synthetic 256^3 cases of 3 objects of
    CORR_POINTS points (`_case_objects`): ms an iteration of each CPD loop
    at the path's sizes (rigid 12 288 x 12 288, deformable M = N = 4096)
    and the host synchronisations of one call of each
    (`torch.cuda.set_sync_debug_mode`, where they happen); then 'simple'
    mode over every case (counts from 0 before, read after: exactly 3 K5
    launches, one an object, and no other kernel), K5 held against its
    plain version at those calls, 'kmeans' on the first CORR_KMEANS_CASES;
    `_check_correspondences` on both. Card against CPU on CORR_REF: the
    similarity transforms within CORR_TOL, a CORR_TOL["share"] of the
    corresponding points within CORR_TOL["near"] voxels and the mean
    distance between cases within CORR_TOL["mean_rtol"]: the deformable
    M-step's solve amplifies rounding once sigma^2 nears its floor, which
    can move a nearest moved point (tests/test_torch_correspondences.py;
    readings of the first H100 call: rotation 1.2e-6, translation 1.8e-4
    voxels, scale 3e-7, every point within 1e-2, the mean distance 1.6e-6
    apart). Returns (counts, K1/K2/K5 calls, timing)."""
    from concurrent.futures import ThreadPoolExecutor

    from fissure_segmentation_tpu_torch.kernels.fps import (fps_cuda,
                                                            fps_plain)
    from fissure_segmentation_tpu_torch.shape_model import \
        generate_corresponding_points
    from fissure_segmentation_tpu_torch.shape_model.registration import (
        register_cpd_deformable, register_cpd_rigid)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(CORR_CASES) as pool:
        cases = list(pool.map(_case_objects, range(CORR_CASES)))
    timing = {"make_cases_s": time.perf_counter() - t0,
              "points_per_label": [int((_ct(s)["labels"] == lbl).sum())
                                   for s in (0, 1) for lbl in (1, 2, 3)]}
    fixed = torch.from_numpy(np.concatenate(cases[0])).cuda()
    moving = torch.from_numpy(np.concatenate(cases[1])).cuda()
    obj_f = torch.from_numpy(cases[0][0]).cuda()
    obj_m = torch.from_numpy(cases[1][0]).cuda()
    loops = {"rigid": lambda: register_cpd_rigid(fixed, moving,
                                                 max_iter=CORR_ITERS),
             "deformable": lambda: register_cpd_deformable(
                 obj_f, obj_m, max_iter=CORR_ITERS)}
    for name, fn in loops.items():
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        timing[f"{name}_ms_per_iter"] = \
            (time.perf_counter() - t1) * 1e3 / CORR_ITERS
        _, sites = _sync_sites(fn)
        timing[f"{name}_host_syncs"] = sites
    del fixed, moving
    torch.cuda.empty_cache()

    _reset(ks, knn_cuda)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = generate_corresponding_points(cases)
    timing["simple_s"] = time.perf_counter() - t1
    counts, calls = _counts(ks, knn_cuda), _slice_calls(ks, knn_cuda)
    if counts["fps"] != 3 or any(n for k, n in counts.items() if k != "fps"):
        raise AssertionError(f"correspondences: launches {counts}, not "
                             "3 of K5 alone")
    timing["simple"] = _check_correspondences(out, CORR_CASES, "simple")
    for o in range(3):
        x = torch.from_numpy(cases[0][o]).cuda()[None]
        if not torch.equal(fps_cuda(x, 256), fps_plain(x, 256)):
            raise AssertionError(f"correspondences: K5 differs from plain "
                                 f"on object {o + 1}")
    t1 = time.perf_counter()
    kout = generate_corresponding_points(cases[:CORR_KMEANS_CASES],
                                         mode="kmeans")
    timing["kmeans_s"] = time.perf_counter() - t1
    timing["kmeans"] = _check_correspondences(kout, CORR_KMEANS_CASES,
                                              "kmeans")

    ref = [[o[:CORR_REF["points"]] for o in c]
           for c in cases[:CORR_REF["cases"]]]
    kw = {"n_per_object": CORR_REF["n_per_object"]}
    got = generate_corresponding_points(ref, device="cuda", **kw)
    want = generate_corresponding_points(ref, device="cpu", **kw)
    diff = {k: max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
                   for a, b in zip(got[2], want[2]))
            for k in ("rotation", "translation", "scale")}
    near = float((np.linalg.norm(got[0] - want[0], axis=-1)
                  <= CORR_TOL["near"]).mean())
    mean_g = np.linalg.norm(got[0][1:] - got[0][:1], axis=-1).mean()
    mean_w = np.linalg.norm(want[0][1:] - want[0][:1], axis=-1).mean()
    timing["reference"] = {**diff, "near_share": near,
                           "mean_dist_card": float(mean_g),
                           "mean_dist_cpu": float(mean_w)}
    if any(diff[k] > CORR_TOL[k] for k in diff) or near < CORR_TOL["share"] \
            or abs(mean_g - mean_w) > CORR_TOL["mean_rtol"] * mean_w:
        raise AssertionError(f"correspondences: card against CPU "
                             f"{timing['reference']} over {CORR_TOL}")
    print(f"correspondences: {json.dumps(timing)} on {card}", flush=True)
    return counts, calls, timing


def _sinusoid(shape, amp: float, device) -> torch.Tensor:
    """tests/test_adam_registration.py's smooth normalized-xyz field, zero
    near the faces."""
    from fissure_segmentation_tpu_torch.shape_model.adam_registration import \
        _identity_grid_xyz
    idx = _identity_grid_xyz(shape, device)
    window = torch.prod(torch.cos(idx * np.pi / 2) ** 2, dim=-1,
                        keepdim=True)
    return amp * torch.sin(idx * np.pi * 1.5) * window


def _registration_pair(case: dict, device, amp: float = 0.05) -> dict:
    """The case in HU as the moving image; the fixed image and its labels
    are the moving ones warped by `_sinusoid` (labels nearest)."""
    from fissure_segmentation_tpu_torch.shape_model.adam_registration import \
        warp_volume
    shape = tuple(case["image"].shape)
    disp = _sinusoid(shape, amp, device)
    mov = {"img": torch.from_numpy(case["image"] * 1000.0).to(device),
           "mask": torch.from_numpy(case["lung_mask"]).to(device),
           "fissures_poisson": torch.from_numpy(case["labels"]).to(device),
           "lobes": torch.from_numpy(case["lobes"]).to(device)}
    fix = {k: warp_volume(v.float(), disp, "bilinear" if k == "img"
                          else "nearest") for k, v in mov.items()}
    fix = {k: v if k == "img" else v.to(mov[k].dtype) for k, v in fix.items()}
    return {"fix": fix, "mov": mov, "disp": disp}


def _smooth_image(shape, seed: int, device) -> torch.Tensor:
    """tests/test_adam_registration.py's band-limited volume (its
    jax.image.resize upsampling is F.interpolate's trilinear,
    align_corners=False)."""
    small = np.random.RandomState(seed).randn(*[max(2, s // 4)
                                                for s in shape])
    img = torch.nn.functional.interpolate(
        torch.from_numpy(small).float()[None, None].to(device), size=shape,
        mode="trilinear", align_corners=False)[0, 0]
    return img / (img.abs().max() + 1e-9)


def _jax_test_recovery() -> dict:
    """tests/test_adam_registration.py:47-78 on the card: 24^3, a sinusoid
    of amplitude 0.08, 80 Adam steps at lr 0.5 and lambda 0.1; its bounds:
    the loss falls below 0.3 x the first, the warped image's squared error
    below 0.35 x the unregistered one, TRE at 50 landmarks below 0.6 x."""
    from fissure_segmentation_tpu_torch.shape_model import adam_registration \
        as ar
    from fissure_segmentation_tpu_torch.utils.sampling import \
        grid_sample_volume
    shape = (24, 24, 24)
    moving = _smooth_image(shape, 1, "cuda")
    disp_gt = _sinusoid(shape, 0.08, "cuda")
    fixed = ar.warp_volume(moving, disp_gt)
    disp_lo, losses = ar.dense_adam_registration(
        ar.downsample_mean(fixed[None], 2), ar.downsample_mean(moving[None], 2),
        iters=80, lambda_weight=0.1, lr=0.5)
    disp = ar.upsample_displacement(disp_lo, shape)
    warped = ar.warp_volume(moving, disp)
    lms = torch.from_numpy(np.random.RandomState(3).uniform(
        -0.5, 0.5, (50, 3))).float().cuda()
    lm_mov = lms + grid_sample_volume(disp_gt.permute(3, 0, 1, 2), lms).T
    before, after = ar.landmark_tre_mm(lms, lm_mov, disp, (1.0, 1.0, 1.0))
    out = {"loss_ratio": float(losses[-1] / losses[0]),
           "error_ratio": float(torch.mean((warped - fixed) ** 2)
                                / torch.mean((moving - fixed) ** 2)),
           "tre_ratio": float(after.mean() / before.mean())}
    if not (out["loss_ratio"] < 0.3 and out["error_ratio"] < 0.35
            and out["tre_ratio"] < 0.6):
        raise AssertionError(f"register: the JAX test's bounds {out}")
    return out


def phase_register(card: str) -> dict:
    """register_images at full width through the entry (`main()`, its
    defaults: 50 Adam steps, lambda 0.65, lr 1, the warped image, the
    disp/disp_lo npz and TRE): the moving image is the shared 256^3 case
    in HU with its lung mask, fissure labels and lobes, the fixed one that
    warped by `_sinusoid` (amplitude 0.05; labels nearest), as uncompressed
    NIfTI files found by the entry's naming; REG_LANDMARKS landmarks on
    lung voxels of the fixed image, the moving ones displaced by the
    sinusoid. Checks: the loss falls, TRE after below TRE before, the
    files' shapes; the synced seconds of each stage (io, features, the
    Adam loop and its ms a step, upsample, warp) and the peak memory. Then
    `_jax_test_recovery`, and card against CPU at REG_REF_SHAPE (the same
    pair, `register_images`' defaults): the first loss within
    REG_TOL["first_loss"], the last within REG_TOL["final_loss"], the mean
    |disp difference| within REG_TOL["disp"] x the mean |disp| (readings
    of the first H100 call: 1.2e-7, 1.2e-7, 1.7e-6). The field starts at
    zero, on the kinks of the trilinear interpolation, where the one-sided
    derivative follows the last bit of a coordinate, and Adam's first
    steps are +-lr whatever a gradient's size: a rounding difference there
    sends a voxel's steps another way (between the port and JAX's fused
    XLA code at 24^3 the field moved by 17 % of its largest entry,
    tests/test_torch_adam_registration.py), which the limits leave room
    for."""
    from fissure_segmentation_tpu_torch import register_images
    from fissure_segmentation_tpu_torch.shape_model import adam_registration \
        as ar
    from fissure_segmentation_tpu_torch.utils.coords import kpts_to_grid
    from fissure_segmentation_tpu_torch.utils.nifti import load_nifti, save_nifti
    from fissure_segmentation_tpu_torch.utils.sampling import \
        grid_sample_volume
    case = _synthetic_ct_once()
    pair = _registration_pair(case, "cuda")
    with tempfile.TemporaryDirectory() as d:
        paths = {}
        for side in ("fix", "mov"):
            for k, v in pair[side].items():
                paths[(side, k)] = os.path.join(d, f"case_{k}_{side}.nii")
                save_nifti(paths[(side, k)], v.cpu().numpy())
        rng = np.random.default_rng(46)
        lung = np.argwhere(pair["fix"]["mask"].cpu().numpy())
        pick = lung[rng.choice(len(lung), REG_LANDMARKS, replace=False)]
        lm_fix = kpts_to_grid(pick[:, ::-1].astype(np.float32), SHAPE)
        lm_fix_t = torch.from_numpy(np.ascontiguousarray(lm_fix)).cuda()
        lm_mov = (lm_fix_t + grid_sample_volume(
            pair["disp"].permute(3, 0, 1, 2), lm_fix_t).T).cpu().numpy()
        np.savez(os.path.join(d, "lms.npz"), lm_fix=lm_fix, lm_mov=lm_mov)
        argv = ["-F", paths[("fix", "img")], "-M", paths[("mov", "img")],
                "-f", paths[("fix", "mask")], "-m", paths[("mov", "mask")],
                "-w", os.path.join(d, "warped.nii"),
                "-d", os.path.join(d, "disp.npz"),
                "-l", os.path.join(d, "lms.npz")]
        del pair
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stages = {}
        t0 = time.perf_counter()
        res = register_images.main(argv, stages=stages)
        took = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = res["losses"].cpu().numpy()
        warped = load_nifti(os.path.join(d, "warped.nii")).array
        with np.load(os.path.join(d, "disp.npz")) as z:
            shapes = (z["disp"].shape, z["disp_lo"].shape)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"register: losses {losses[0]} -> {losses[-1]}")
    before, after = res["tre"]
    if not after < before:
        raise AssertionError(f"register: TRE {before} -> {after} mm")
    lo = tuple(s // 2 for s in SHAPE)
    if warped.shape != SHAPE or shapes != ((*SHAPE, 3), (*lo, 3)):
        raise AssertionError(f"register: outputs {warped.shape} {shapes}")
    del res
    torch.cuda.empty_cache()
    timing = {"entry_s": took, "stages_s": stages,
              "adam_ms_per_step": stages["adam"] * 1e3 / len(losses),
              "peak_gib": peak / 2 ** 30, "loss_first": float(losses[0]),
              "loss_last": float(losses[-1]), "tre_before_mm": before,
              "tre_after_mm": after, "jax_test": _jax_test_recovery()}

    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    small = make_synthetic_image_case(0, shape=REG_REF_SHAPE)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = _registration_pair(small, dev)
        outs[dev] = ar.register_images(
            p["fix"]["img"], p["mov"]["img"], mask_fix=p["fix"]["mask"],
            mask_mov=p["mov"]["mask"], fissures_fix=p["fix"]["fissures_poisson"],
            fissures_mov=p["mov"]["fissures_poisson"],
            lobes_fix=p["fix"]["lobes"], lobes_mov=p["mov"]["lobes"])
    lg, lw = outs["cuda"]["losses"].cpu().numpy(), outs["cpu"]["losses"].numpy()
    dg, dw = outs["cuda"]["disp"].cpu().numpy(), outs["cpu"]["disp"].numpy()
    ref = {"first_loss": float(abs(lg[0] / lw[0] - 1)),
           "final_loss": float(abs(lg[-1] / lw[-1] - 1)),
           "disp": float(np.abs(dg - dw).mean() / np.abs(dw).mean())}
    timing["reference"] = ref
    if any(ref[k] > REG_TOL[k] for k in ref):
        raise AssertionError(f"register: card against CPU {ref} over "
                             f"{REG_TOL}")
    print(f"register: {json.dumps(timing)} on {card}", flush=True)
    return timing


def _write_case_layout(folder: str, case: dict, pred_dir: str) -> None:
    """One case in LungDataIndex's layout (the image in HU as int16, the
    fissure labels, the lung mask) and its prediction: the ground-truth
    fissures shifted by one voxel along z."""
    from concurrent.futures import ThreadPoolExecutor

    from fissure_segmentation_tpu_torch.utils.nifti import save_nifti
    cid = case["case_id"]
    files = [(os.path.join(folder, f"{cid}_img_fixed.nii.gz"),
              (case["image"] * 1000.0).astype(np.int16)),
             (os.path.join(folder, f"{cid}_fissures_fixed.nii.gz"),
              case["labels"].astype(np.uint8)),
             (os.path.join(folder, f"{cid}_mask_fixed.nii.gz"),
              case["lung_mask"].astype(np.uint8)),
             (os.path.join(pred_dir, f"{cid}_fixed.nii.gz"),
              np.roll(case["labels"], 1, axis=0).astype(np.uint8))]
    with ThreadPoolExecutor(len(files)) as pool:
        list(pool.map(lambda f: save_nifti(*f), files))


def _baseline_csvs(out: str, mode: str, n_fissures: int = 3) -> dict:
    """The JAX entry's CSV layout (write_results' rows, the CPU test holds
    the port's against the JAX entry's) with finite values; returns the
    numeric rows."""
    rows = _csv(os.path.join(out, "fold0", f"test_results_{mode}.csv"))
    if [r[0] if r else None for r in rows] != RESULT_ROWS or \
            any(len(r) != n_fissures + 2 for r in rows if r and
                r[0] != "Class"):
        raise AssertionError(f"baselines {mode}: layout {rows}")
    cv = _csv(os.path.join(out, f"cv_results_{mode}.csv"))
    if cv[0] != ["fold", "assd", "dice"] or len(cv) != 2:
        raise AssertionError(f"baselines {mode}: cv_results {cv}")
    values = {r[0]: np.asarray(r[1:], float) for r in rows
              if r and r[0] not in ("Class", "Fissure")}
    if not all(np.isfinite(v).all() for v in values.values()) or \
            not np.isfinite(np.asarray(cv[1], float)).all():
        raise AssertionError(f"baselines {mode}: values {values} {cv}")
    return values


def phase_baselines(ks, knn_cuda, card: str):
    """evaluate_baselines through its entry (`main()`) in the modes
    "voxels" and "subsample" (20 000 points) on the shared 256^3 cases 0
    and 1 written in LungDataIndex's layout, each prediction its ground
    truth shifted by one voxel (counts from 0 before the two runs, read
    after: K1 alone, the Poisson fits' normals, at least one call on its
    tiled branch, above K1_STAGED_POINTS points): `_baseline_csvs`; s/case
    by stage (reading, fits, surface samples, metrics); K1 held against
    its plain version at the voxels run's clouds (`phase_preprocess_
    kernels`). Then card against CPU on one EB_REF_SHAPE case with the same
    surface-sample draws: Dice and the missing share equal, the ASSD family
    within rtol EB_TOL (K1 equals its plain version; the PSR's FFTs and the
    metrics' sums differ by rounding). Returns (counts, calls, K1 timings,
    timing)."""
    from fissure_segmentation_tpu_torch import evaluate_baselines
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_image_case
    from fissure_segmentation_tpu_torch.utils.coords import kpts_to_grid
    timing, clouds = {}, {}
    with tempfile.TemporaryDirectory() as d:
        data, preds = os.path.join(d, "data"), os.path.join(d, "preds")
        os.makedirs(data)
        os.makedirs(preds)
        t0 = time.perf_counter()
        for seed in (0, 1):
            _write_case_layout(data, _ct(seed), preds)
        timing["write_s"] = time.perf_counter() - t0
        for seed in (0, 1):
            pred = np.roll(_ct(seed)["labels"], 1, axis=0)
            for lbl in (1, 2, 3):
                world = np.argwhere(pred == lbl)[:, ::-1].astype(np.float32)
                g = np.ascontiguousarray(kpts_to_grid(world, SHAPE)[:, ::-1])
                clouds[f"case{seed}_{lbl}"] = torch.from_numpy(g)[None].cuda()
        _reset(ks, knn_cuda)
        for mode in ("voxels", "subsample"):
            stages = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate_baselines.main(
                ["--result_dir", preds, "--data_dir", data, "--output",
                 os.path.join(d, mode), "--mode", mode], stages=stages)
            took = time.perf_counter() - t0
            values = _baseline_csvs(os.path.join(d, mode), mode)
            timing[mode] = {"s_per_case": took / 2,
                            "stages_s_per_case": {k: v / 2 for k, v in
                                                  stages.items()},
                            "mean_assd": values["Mean ASSD"].tolist(),
                            "mean_dice": values["Mean Dice"].tolist()}
        counts, calls = _counts(ks, knn_cuda), _slice_calls(ks, knn_cuda)
    tiled = sum(n for key, n in calls["knn"].items()
                if int(key.split("x")[1]) > K1_STAGED_POINTS)
    if any(n for k, n in counts.items() if k != "knn") or tiled < 1:
        raise AssertionError(f"baselines: launches {counts}, K1 calls "
                             f"{calls['knn']}")
    timing["k1_calls"], timing["k1_tiled_launches"] = calls["knn"], tiled
    k1, _, _ = phase_preprocess_kernels(clouds, {})
    del clouds
    torch.cuda.empty_cache()

    small = make_synthetic_image_case(0, shape=EB_REF_SHAPE)
    g = torch.Generator().manual_seed(47)
    draws = {(small["case_id"], "fixed"): {
        lbl: (torch.rand((10000,), generator=g),
              torch.rand((10000, 2), generator=g)) for lbl in (1, 2, 3)}}
    got = {}
    with tempfile.TemporaryDirectory() as d:
        data, preds = os.path.join(d, "data"), os.path.join(d, "preds")
        os.makedirs(data)
        os.makedirs(preds)
        _write_case_layout(data, small, preds)
        for dev in ("cuda", "cpu"):
            evaluate_baselines.main(
                ["--result_dir", preds, "--data_dir", data, "--output",
                 os.path.join(d, dev)], device=dev, draws=draws)
            got[dev] = _baseline_csvs(os.path.join(d, dev), "voxels")
    rel = 0.0
    for name, want in got["cpu"].items():
        have = got["cuda"][name]
        if name.endswith("Dice") or name == "proportion missing":
            if not np.array_equal(have, want):
                raise AssertionError(f"baselines: {name} card {have}, CPU "
                                     f"{want}")
            continue
        rel = max(rel, float(np.max(np.abs(have - want)
                                    / np.maximum(np.abs(want), 1e-12))))
    timing["reference_assd_family_rtol"] = rel
    if rel > EB_TOL:
        raise AssertionError(f"baselines: card against CPU rtol {rel} > "
                             f"{EB_TOL}")
    print(f"baselines: {json.dumps(timing)} on {card}", flush=True)
    return counts, calls, k1, timing


def phase_shape_probes(ks, knn_cuda, card: str):
    """The three probes of shape_sanity_checks at the entry's defaults, held
    to tests/test_shape_sanity.py's bounds (weights: error below 0.05;
    eigenvectors: below max(3 x the PCA optimum, 0.02); the DG-SSM toy,
    30 epochs x 10 steps of 8 x 256 points, k = 10, static: the last
    epoch's error below 0.9 x the first; counts from 0 before the toy,
    read after: a step launches K1 once, the transpose once and K2 four
    times, nothing else), and `fit_plane_to_fissure` on each fissure's
    voxels of the shared 256^3 case: a unit normal, and a Huber objective
    no larger than the least-squares start's. Returns (counts, calls,
    timing)."""
    import torch.nn.functional as F

    from fissure_segmentation_tpu_torch import shape_sanity_checks as sanity
    from fissure_segmentation_tpu_torch.postprocess.plane_fitting import (
        fit_plane_to_fissure, plane_from_points_lstsq)
    timing = {}
    t0 = time.perf_counter()
    err, base = sanity.sanity_check_weights(verbose=False)
    timing["weights"] = {"s": time.perf_counter() - t0, "error": err,
                         "baseline": base}
    if not err < 0.05:
        raise AssertionError(f"probes: weights {err} (baseline {base})")
    t0 = time.perf_counter()
    err, opt = sanity.sanity_check_eigenvectors(verbose=False)
    timing["eigenvectors"] = {"s": time.perf_counter() - t0, "error": err,
                              "optimum": opt}
    if not err < max(3 * opt, 0.02):
        raise AssertionError(f"probes: eigenvectors {err} (optimum {opt})")
    _reset(ks, knn_cuda)
    t0 = time.perf_counter()
    errs = sanity.dgssm_rigid_toy_example(verbose=False)
    timing["dgssm"] = {"s": time.perf_counter() - t0, "first": errs[0],
                       "last": errs[-1]}
    counts, calls = _counts(ks, knn_cuda), _slice_calls(ks, knn_cuda)
    steps = 300
    want = {"knn": steps, "transpose": steps, "scatter_rows": 4 * steps}
    if not errs[-1] < 0.9 * errs[0] or \
            any(counts[k] != want.get(k, 0) for k in counts):
        raise AssertionError(f"probes: dgssm errors {errs[0]} -> {errs[-1]},"
                             f" launches {counts}")
    labels = _synthetic_ct_once()["labels"]
    timing["planes"] = {}
    for lbl in (1, 2, 3):
        pts = torch.from_numpy(
            np.argwhere(labels == lbl)[:, ::-1].astype(np.float32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, d = fit_plane_to_fissure(pts)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        n0, d0 = plane_from_points_lstsq(pts)

        def huber(n_, d_):
            dist = pts @ n_ - d_
            return float(F.huber_loss(dist, torch.zeros_like(dist),
                                      delta=1.0))
        fit, start = huber(n, d), huber(n0, d0)
        timing["planes"][lbl] = {"s": took, "points": len(pts),
                                 "huber": fit, "huber_lstsq": start}
        if abs(float(torch.linalg.norm(n)) - 1) > 1e-5 or not fit <= start:
            raise AssertionError(f"probes: plane {lbl}: |n| "
                                 f"{float(torch.linalg.norm(n))}, Huber "
                                 f"{fit} against {start}")
    print(f"shape probes: {json.dumps(timing)} on {card}", flush=True)
    return counts, calls, timing


# ---- the parallel layer (phases 49-52) --------------------------------------
#
# One card: NCCL refuses two ranks on one device, so the layer runs in two
# ways, each in ranks spawned by parallel/mesh.py:spawn: a one-rank NCCL
# group on cuda:0 (the production backend's collectives) and a two-rank
# gloo group whose ranks both compute on cuda:0 (a real split of the work;
# the collectives go through host memory, and the two ranks share the SMs,
# so their times are no speed-up). Each rank sets the launch counts to 0
# just before each main path and reads them just after, and returns them.

PAR_RANKS = 2
PAR_STEPS = 10                 # phase 49's trajectory
PAR_BATCH, PAR_POINTS, PAR_K = 32, 2048, 40    # the default run's widths
PAR_CASE_POINTS = 8000         # points of each of the 4 training cases
PAR_MAX_KPTS = 20000           # the serving default
PAR_SEED = 49
PAR_TRAJ_TOL = dict(rtol=3e-2, atol=3e-2)   # __graft_entry__.py:164
PAR_NCCL_TOL = 1e-6
PAR_WINDOW_TOL = 2e-5          # tests/test_spatial_sharding.py:97
PAR_ENSEMBLE_TOL = 1e-5
PAR_KNN_TOL = 1e-4
PAR_GAP = 1e-4                 # top-two gap below which an argmax may flip
PAR_SUBSETS = (50, 2048, 5)    # subsets, points, subsets a group
PAR_WINDOW = dict(patch_size=(128, 128, 128), min_overlap=0.5)


def _par_counts() -> tuple:
    """The launch counts and the calls by key of every wrapper, since the
    last `_par_zero` (in a rank)."""
    from fissure_segmentation_tpu_torch.kernels import scatter as ks
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    w = _wrappers(ks, knn_cuda)
    return ({k: fn.launches for k, fn in w.items()},
            {k: dict(fn.calls) for k, fn in w.items() if hasattr(fn, "calls")},
            {k: dict(fn.roles) for k, fn in w.items() if hasattr(fn, "roles")})


def _par_zero() -> None:
    from fissure_segmentation_tpu_torch.kernels import scatter as ks
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    _reset(ks, knn_cuda)


def _par_model(kind: str):
    """The models from a seed: "bf16" the default run's DGCNNSeg(k=40,
    dynamic, bf16), "f32" DGCNNSeg(k=40, static, f32) (phase 49), "serve"
    the serving one, DGCNNSeg(k=40, static, f32) on coordinates (phase
    50)."""
    from fissure_segmentation_tpu_torch.models import DGCNNSeg
    kw = dict(dtype=torch.bfloat16) if kind == "bf16" else dict(dynamic=False)
    return DGCNNSeg(k=PAR_K, in_features=3 if kind == "serve" else 4,
                    num_classes=4,
                    generator=torch.Generator().manual_seed(PAR_SEED), **kw)


def _par_trainer(ds, loss_fn, kind, group, out_dir, device):
    from fissure_segmentation_tpu_torch.train.trainer import (ModelTrainer,
                                                              TrainConfig)
    return ModelTrainer(_par_model(kind), ds, loss_fn, out_dir,
                        TrainConfig(batch_size=PAR_BATCH, scheduler="none"),
                        device=device, group=group)


def _par_steps(tr, inp, rows, timed: bool) -> dict:
    """PAR_STEPS steps of the trainer on inp's case indices from one
    generator (rows: this rank's), counted; then the busy share over 3
    more. Returns the losses, ms/step over the steps after the first two,
    peak memory and the counts."""
    gen = tr._generator(PAR_SEED)
    idx = torch.as_tensor(inp["step_idx"], device=tr.device)

    def step(i):
        x, y = tr._draw(gen, idx[i % len(idx)], True, rows)
        return tr.train_step(x, y)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _par_zero()
    losses, t0 = [], None
    for i in range(PAR_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(float(step(i)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (PAR_STEPS - 2) * 1e3
    counts = _par_counts()
    out = {"losses": losses, "ms_per_step": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "counts": counts}
    if timed:
        out["busy_share"] = _profiled_busy(lambda: step(0))
    return out


def _par_f32_step(tr, inp, rows) -> dict:
    """One static f32 step on the injected batch (rows: this rank's):
    the loss and every parameter's gradient."""
    x = torch.as_tensor(inp["f32_x"], device=tr.device)
    y = torch.as_tensor(inp["f32_y"], device=tr.device).long()
    if rows is not None:
        x, y = x[rows], y[rows]
    loss, _ = tr.train_step(x, y)
    return {"loss": float(loss),
            "grads": {n: p.grad.detach().cpu().numpy()
                      for n, p in tr.model.named_parameters()
                      if p.grad is not None}}


def _par_data(inp, device):
    from fissure_segmentation_tpu_torch.data.dataset import PointDataset
    from fissure_segmentation_tpu_torch.losses import get_loss_fn
    ds = PointDataset(copy.deepcopy(inp["cases"]), sample_points=PAR_POINTS)
    return ds, get_loss_fn("nnunet", torch.as_tensor(
        ds.get_class_weights(), device=device))


def _par_serving_model(inp, device):
    """The serving model with its seeded weights and bench.py's class bias
    (biased_model: every class gets keypoints, so every class's mesh is
    compared)."""
    seg = _par_model("serve").to(device).eval()
    seg.load_state_dict({k: torch.as_tensor(v) for k, v in
                         inp["seg_state"].items()})
    return biased_model(seg, {"surface_params": inp["surface_params"]},
                        SHAPE)


def _par_serving(mesh, inp, what: str) -> dict:
    """The sharded subset ensemble on the case's keypoints, the sliding
    window on the CT (unless `what` leaves it out) and the ring kNN of the
    keypoints; counts from 0 before each, read after."""
    from fissure_segmentation_tpu_torch.kernels import approx_topk
    from fissure_segmentation_tpu_torch.models import MobileNetASPP
    from fissure_segmentation_tpu_torch.parallel import (
        points, shard_along, sharded_ensemble_predict, sharded_knn,
        sharded_predict_all_patches)
    dev, out = mesh.device, {}
    seg = _par_serving_model(inp, dev)
    pc = torch.as_tensor(inp["coords"], device=dev)
    n_runs, pts, group = PAR_SUBSETS
    subsets = torch.as_tensor(inp["subsets"], device=dev)
    torch.cuda.synchronize()
    _par_zero()
    t0 = time.perf_counter()
    probs = sharded_ensemble_predict(seg, pc, mesh, sample_points=pts,
                                     subset_batch=group, subsets=subsets)
    torch.cuda.synchronize()
    out["ensemble"] = {"s": time.perf_counter() - t0,
                       "counts": _par_counts()}
    if mesh.rank == 0:
        out["ensemble"]["probs"] = probs.cpu().numpy()
    del probs

    if "window" in what:
        cnn = MobileNetASPP(num_classes=4).to(dev).eval()
        cnn.load_state_dict({k: torch.as_tensor(v) for k, v in
                             inp["cnn_state"].items()})
        img = torch.as_tensor(inp["image"], device=dev)
        torch.cuda.synchronize()
        _par_zero()
        t0 = time.perf_counter()
        soft = sharded_predict_all_patches(cnn, img, 4, mesh, **PAR_WINDOW)
        torch.cuda.synchronize()
        out["window"] = {"s": time.perf_counter() - t0,
                         "counts": _par_counts()}
        if mesh.rank == 0:
            out["window"]["soft"] = soft.cpu().numpy()
        del soft, img

    # the ring kNN; the merge's selections recorded for the check after
    kp = torch.as_tensor(inp["ring_points"], device=dev)
    recorded, real = [], points.select_rows

    def recording(x, *a, **kw):
        res = real(x, *a, **kw)
        recorded.append((x.clone(), a, kw, res))
        return res
    points.select_rows = recording
    try:
        torch.cuda.synchronize()
        _par_zero()
        t0 = time.perf_counter()
        idx, dist = sharded_knn(shard_along(kp, mesh), PAR_K, mesh,
                                return_dist=True)
        torch.cuda.synchronize()
        out["ring"] = {"s": time.perf_counter() - t0,
                       "counts": _par_counts(),
                       "idx": idx.cpu().numpy(), "dist": dist.cpu().numpy()}
    finally:
        points.select_rows = real
    same = 0
    for x, a, kw, (vals, sel) in recorded:
        pv, pi = approx_topk.select_rows_plain(x, *a, **kw)
        same += int(torch.equal(vals, pv) and torch.equal(sel, pi))
    out["ring"].update(selections=len(recorded), bit_equal=same,
                       call=recorded[0][0].shape if recorded else None)
    return out


def _par_rank(mesh, inp) -> dict:
    """A rank of the two-rank gloo group on cuda:0: its paths, then, on
    rank 0, the one-rank NCCL subgroup's while rank 1 waits. Returns
    {"gloo2": ..., "nccl1": ... (rank 0)} with each part's seconds."""
    import torch.distributed as dist
    from fissure_segmentation_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    nccl_group = dist.new_group([0], backend="nccl")
    out = {"gloo2": _par_gloo_rank(mesh, inp)}
    t1 = time.perf_counter()
    if mesh.rank == 0:
        out["nccl1"] = _par_nccl_rank(make_mesh(mesh.device, nccl_group),
                                      inp)
    out["s"] = {"gloo2": t1 - t0, "nccl1": time.perf_counter() - t1}
    dist.barrier(group=mesh.group)
    return out


def _par_gloo_rank(mesh, inp) -> dict:
    """The two-rank gloo group: phase 49's ten bf16 steps and the f32 step,
    then phases 50-52's serving paths."""
    out = {"staged": list(mesh.staged), "rank": mesh.rank}
    ds, loss_fn = _par_data(inp, mesh.device)
    share = PAR_BATCH // mesh.size
    rows = slice(mesh.rank * share, (mesh.rank + 1) * share)
    with tempfile.TemporaryDirectory() as td:
        tr = _par_trainer(ds, loss_fn, "bf16", mesh.group, td, mesh.device)
        out["train"] = _par_steps(tr, inp, rows, timed=True)
        del tr
        tr = _par_trainer(ds, loss_fn, "f32", mesh.group, td, mesh.device)
        out["f32"] = _par_f32_step(tr, inp, rows)
        del tr
    out.update(_par_serving(mesh, inp, "ensemble window ring"))
    return out


def _par_nccl_rank(mesh, inp) -> dict:
    """The one-rank NCCL group (rank 0's subgroup): the f32 step and phase
    49's ten bf16 steps, then the ensemble and the ring kNN (their
    collectives are NCCL's; one rank's ring sends to itself)."""
    out = {"staged": list(mesh.staged), "rank": mesh.rank}
    ds, loss_fn = _par_data(inp, mesh.device)
    with tempfile.TemporaryDirectory() as td:
        tr = _par_trainer(ds, loss_fn, "f32", mesh.group, td, mesh.device)
        out["f32"] = _par_f32_step(tr, inp, None)
        del tr
        tr = _par_trainer(ds, loss_fn, "bf16", mesh.group, td, mesh.device)
        out["train"] = _par_steps(tr, inp, slice(0, PAR_BATCH), timed=True)
        del tr
    out.update(_par_serving(mesh, inp, "ensemble ring"))
    return out


def _leaf_err(got: dict, want: dict) -> dict:
    """Per parameter: max |got - want| over the largest |want| of the leaf
    (a leaf of float32 noise, below 1e-4 of the largest of all, at that)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    return {k: float(np.abs(got[k] - w).max())
            / max(float(np.abs(w).max()), 1e-4 * top)
            for k, w in want.items()}


def _par_inputs(card: str) -> dict:
    """Everything the ranks take, made once here: the training cases,
    phase 49's step indices and injected f32 batch, the 256^3 case's
    Förstner keypoints (20 000 at most), the serving model's and the CNN's
    seeded weights, the ensemble's subsets."""
    from fissure_segmentation_tpu_torch import serving
    from fissure_segmentation_tpu_torch.data.synthetic import \
        make_synthetic_dataset
    from fissure_segmentation_tpu_torch.models.ensemble import build_subsets
    from fissure_segmentation_tpu_torch.utils.coords import kpts_to_grid
    rng = np.random.default_rng(PAR_SEED)
    inp = {"cases": make_synthetic_dataset(4, n_points=PAR_CASE_POINTS),
           "step_idx": rng.integers(0, 4, (PAR_STEPS, PAR_BATCH))}
    inp["f32_x"] = rng.normal(size=(PAR_BATCH, PAR_POINTS, 4)).astype(
        np.float32)
    inp["f32_y"] = rng.integers(0, 4, (PAR_BATCH, PAR_POINTS))
    case = synthetic_ct()
    vol = torch.as_tensor(case["image"], dtype=torch.float32, device="cuda")
    mask = torch.as_tensor(case["lung_mask"], device="cuda").to(torch.bool)
    with torch.no_grad():
        kpts, valid, shape = serving._keypoints(
            vol, mask, None, kp_mode="foerstner", max_kpts=PAR_MAX_KPTS,
            fissure_mu=0.0, fissure_sigma=1.0, cnn_model=None,
            cnn_dtype=None, kp_scores=None, approx_top_k=False)
        coords = torch.where(valid[:, None], kpts_to_grid(
            kpts.flip(-1).to(torch.float32), shape), -1.0)
    inp["coords"], inp["valid"] = coords.cpu().numpy(), valid.cpu().numpy()
    ring = inp["coords"][inp["valid"]]
    inp["ring_points"] = ring[:len(ring) // PAR_RANKS * PAR_RANKS]
    inp["image"] = case["image"].astype(np.float32)
    inp["surface_params"] = case["surface_params"]
    inp["seg_state"] = {k: v.cpu().numpy() for k, v in
                        _par_model("serve").state_dict().items()}
    inp["cnn_state"] = {k: v.cpu().numpy() for k, v in
                        _cnn_model(PAR_SEED).state_dict().items()}
    n_runs, pts, _ = PAR_SUBSETS
    inp["subsets"] = build_subsets(len(coords), pts, n_runs,
                                   torch.Generator().manual_seed(PAR_SEED)
                                   ).numpy()
    print(f"parallel inputs: {int(valid.sum())} keypoints of the 256^3 "
          f"case, ring cloud {len(inp['ring_points'])} points, "
          f"{inp['subsets'].shape[0]} subsets; {card}", flush=True)
    return inp


def _par_single(inp) -> dict:
    """The same work on one device without a group (the parent process):
    the ten bf16 steps, the f32 step and the f32 step on the batch's rows
    in another order (its reduction-order spread)."""
    ds, loss_fn = _par_data(inp, "cuda")
    out = {}
    with tempfile.TemporaryDirectory() as td:
        tr = _par_trainer(ds, loss_fn, "bf16", None, td, "cuda")
        out["train"] = _par_steps(tr, inp, None, timed=True)
        del tr
        tr = _par_trainer(ds, loss_fn, "f32", None, td, "cuda")
        out["f32"] = _par_f32_step(tr, inp, None)
        del tr
        perm = np.roll(np.arange(PAR_BATCH), PAR_BATCH // 2)
        tr = _par_trainer(ds, loss_fn, "f32", None, td, "cuda")
        out["f32_perm"] = _par_f32_step(
            tr, {"f32_x": inp["f32_x"][perm], "f32_y": inp["f32_y"][perm]},
            None)
    return out


def phase_parallel_train(card: str, inp: dict, gloo: list, nccl: list,
                         single: dict) -> dict:
    """Phase 49: data-parallel training at the default run's width. The two
    gloo ranks' ten bf16 steps against one device's (the trajectory within
    JAX's own data-parallel bound); the f32 step's loss within 1e-5
    relative and every gradient within 4x the single device's own
    reduction-order spread (the same step with the rows in another order:
    where a max over k or a LeakyReLU takes the other branch, a leaf moves
    by up to 1e-2 of its largest magnitude on a small model) or 1e-2 of
    the leaf's largest magnitude, and the whole gradient within 4x that
    spread in relative L2; the one-rank NCCL trainer against the no-group
    one within
    1e-6 relative; ms/step, peak memory and the busy share of each."""
    out = {"card": card}
    h1 = np.asarray(single["train"]["losses"])
    for name, ranks in (("gloo2", gloo), ("nccl1", nccl)):
        hn = np.asarray(ranks[0]["train"]["losses"])
        if not all(r["train"]["losses"] == ranks[0]["train"]["losses"]
                   for r in ranks):
            raise AssertionError(f"parallel train {name}: ranks disagree on "
                                 "the loss")
        np.testing.assert_allclose(hn, h1, err_msg=name, **PAR_TRAJ_TOL)
        out[name] = {"max_loss_diff": float(np.abs(hn - h1).max()),
                     **{k: [r["train"][k] for r in ranks] for k in
                        ("ms_per_step", "peak_gib", "busy_share")},
                     "staged": ranks[0]["staged"]}
    out["single"] = {k: single["train"][k] for k in
                     ("ms_per_step", "peak_gib", "busy_share")}
    f1 = single["f32"]
    spread = _leaf_err(single["f32_perm"]["grads"], f1["grads"])
    for name, ranks in (("gloo2", gloo), ("nccl1", nccl)):
        g = ranks[0]["f32"]
        rel = abs(g["loss"] - f1["loss"]) / abs(f1["loss"])
        err = _leaf_err(g["grads"], f1["grads"])
        if name == "nccl1":
            bad = {k: e for k, e in err.items() if e > PAR_NCCL_TOL}
            if rel > PAR_NCCL_TOL or bad:
                raise AssertionError(f"parallel nccl1: loss {rel:.2e}, "
                                     f"gradients {bad}")
        else:
            bad = {k: (e, spread[k]) for k, e in err.items()
                   if e > max(4 * spread[k], 1e-2)}
            l2, l2_spread = (_rel_l2(g["grads"], f1["grads"]),
                             _rel_l2(single["f32_perm"]["grads"],
                                     f1["grads"]))
            if rel > 1e-5 or bad or l2 > max(4 * l2_spread, 1e-5):
                raise AssertionError(f"parallel gloo2 f32 step: loss "
                                     f"{rel:.2e}, gradients {bad}, rel L2 "
                                     f"{l2:.2e} (spread {l2_spread:.2e})")
            out[name].update(f32_grad_rel_l2=l2,
                             f32_grad_rel_l2_spread=l2_spread)
        out[name].update(f32_loss_rel=rel, f32_grad_worst=max(err.values()))
    out["f32_grad_spread_worst"] = max(spread.values())
    print(json.dumps({"parallel_train": out}), flush=True)
    return out


def phase_parallel_ensemble(card: str, inp: dict, gloo: list,
                            nccl: list) -> dict:
    """Phase 50: the sharded subset ensemble in serving against
    ensemble_predict on the same subsets (probabilities within 1e-5, the
    argmax equal wherever the top two are more than 1e-4 apart) and the
    PSR/marching meshes built from the two predictions equal for every
    class whose keypoints the two agree on."""
    from fissure_segmentation_tpu_torch.models import ensemble_predict
    from fissure_segmentation_tpu_torch.postprocess.surface_fitting import \
        batched_psr_mc
    seg = _par_serving_model(inp, "cuda")
    coords = torch.as_tensor(inp["coords"], device="cuda")
    valid = torch.as_tensor(inp["valid"], device="cuda")
    n_runs, pts, group = PAR_SUBSETS
    subsets = torch.as_tensor(inp["subsets"], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = ensemble_predict(seg, coords, sample_points=pts,
                           subset_batch=group, subsets=subsets)
    torch.cuda.synchronize()
    out = {"card": card, "single_s": time.perf_counter() - t0}
    top2 = ref.topk(2, dim=-1).values
    clear = top2[:, 0] - top2[:, 1] > PAR_GAP
    for name, ranks in (("gloo2", gloo), ("nccl1", nccl)):
        probs = torch.as_tensor(ranks[0]["ensemble"]["probs"],
                                device="cuda")
        err = float((probs - ref).abs().max())
        if err > PAR_ENSEMBLE_TOL:
            raise AssertionError(f"parallel ensemble {name}: {err}")
        pred, pred1 = probs.argmax(-1), ref.argmax(-1)
        if not torch.equal(pred[clear], pred1[clear]):
            raise AssertionError(f"parallel ensemble {name}: argmax differs "
                                 "outside the near-ties")
        classes = [valid & (p[None] == torch.arange(1, 4, device="cuda")[
            :, None]) for p in (pred, pred1)]
        meshes = [batched_psr_mc(coords.flip(-1), c, (64, 64, 64), 4.0, 30,
                                 24000) for c in classes]
        equal_classes = 0
        for c in range(3):
            if torch.equal(classes[0][c], classes[1][c]):
                for a, b in zip(meshes[0], meshes[1]):
                    if not torch.equal(a[c], b[c]):
                        raise AssertionError(f"parallel ensemble {name}: "
                                             f"class {c + 1} meshes differ")
                equal_classes += 1
        out[name] = {"max_abs_err": err, "near_ties": int((~clear).sum()),
                     "pred_differs": int((pred != pred1).sum()),
                     "classes_meshes_equal": equal_classes,
                     "triangles": [int(n) for n in meshes[0][2]],
                     "s": [r["ensemble"]["s"] for r in ranks]}
    print(json.dumps({"parallel_ensemble": out}), flush=True)
    return out


def phase_parallel_window(card: str, inp: dict, gloo: list) -> dict:
    """Phase 51: the z-slab sliding window of MobileNetASPP (K6 in every
    block) on the 256^3 CT, two ranks, f32, against predict_all_patches
    (atol 2e-5)."""
    from fissure_segmentation_tpu_torch.models import predict_all_patches
    cnn = _cnn_model(PAR_SEED).cuda().eval()
    img = torch.as_tensor(inp["image"], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = predict_all_patches(cnn, img, 4, **PAR_WINDOW)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    soft = torch.as_tensor(gloo[0]["window"]["soft"], device="cuda")
    err = float((soft - ref).abs().max())
    if soft.shape != ref.shape or err > PAR_WINDOW_TOL:
        raise AssertionError(f"parallel window: {tuple(soft.shape)}, {err}")
    out = {"card": card, "max_abs_err": err, "single_s": single_s,
           "s": [r["window"]["s"] for r in gloo],
           "k6_launches": [r["window"]["counts"][0]["depthwise_conv3"]
                           for r in gloo]}
    print(json.dumps({"parallel_window": out}), flush=True)
    return out


def phase_parallel_knn(card: str, inp: dict, gloo: list, nccl: list,
                       sel_timings: dict) -> dict:
    """Phase 52: the ring kNN of the case's keypoints (k = 40, no self
    loop) on two ranks against K1's dense graph: sorted distances within
    1e-4 relative plus the float32 cancellation of the ring's distance
    formula (8 eps32 of the largest |x|^2; K1 sums exact squares), indices
    equal but at near-ties within that bound, every merge selection
    equal to select_rows_plain bit for bit; the merge's call timed (added to
    `sel_timings`); then dryrun_multichip over two gloo ranks on the
    card."""
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda
    from fissure_segmentation_tpu_torch.parallel.dryrun import \
        dryrun_multichip
    pts = torch.as_tensor(inp["ring_points"], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx1, d1 = knn_cuda(pts[None].contiguous(), PAR_K, False)
    torch.cuda.synchronize()
    out = {"card": card, "points": len(pts),
           "dense_s": time.perf_counter() - t0}
    idx1, d1 = idx1[0].long().cpu().numpy(), d1[0].cpu().numpy()
    # the ring's tile is |x|^2 - 2 x.y + |y|^2 in float32 (the JAX
    # formula), K1 sums exact squares: besides 1e-4 relative, the tile's
    # cancellation, 8 eps32 of the largest |x|^2, is allowed
    atol = 8 * float(np.finfo(np.float32).eps) * float(
        (inp["ring_points"].astype(np.float64) ** 2).sum(-1).max())
    out["atol"] = atol
    for name, ranks in (("gloo2", gloo), ("nccl1", nccl)):
        idx = np.concatenate([r["ring"]["idx"] for r in ranks])
        dist = np.concatenate([r["ring"]["dist"] for r in ranks])
        err = np.abs(np.sort(dist, -1) - np.sort(d1, -1))
        if (err > PAR_KNN_TOL * np.abs(d1) + atol).any():
            raise AssertionError(f"parallel knn {name}: distances "
                                 f"{err.max()}")
        differ = idx != idx1
        # a differing slot is a near-tie: its distance within that bound
        # of the dense graph's at that slot
        gap = np.abs(dist - d1)[differ]
        if (gap > PAR_KNN_TOL * np.abs(d1[differ]) + atol).any():
            raise AssertionError(f"parallel knn {name}: a differing index "
                                 "is no near-tie")
        rel = err / np.maximum(np.abs(d1), 1e-12)
        sels = sum(r["ring"]["selections"] for r in ranks)
        if sum(r["ring"]["bit_equal"] for r in ranks) != sels:
            raise AssertionError(f"parallel knn {name}: a merge selection "
                                 "differs from select_rows_plain")
        out[name] = {"max_dist_rel": float(rel.max()),
                     "max_dist_abs": float(err.max()),
                     "index_differs": int(differ.sum()),
                     "selections_bit_equal": sels,
                     "s": [r["ring"]["s"] for r in ranks]}
    # the merge's call at its shape: rank 0's first candidate rows
    n_loc = len(pts) // PAR_RANKS
    loc = pts[:n_loc]
    from fissure_segmentation_tpu_torch.ops.knn import pairwise_sqdist
    d = pairwise_sqdist(loc, loc).float()
    d.diagonal().fill_(-1.0)
    cand = torch.cat([torch.full((n_loc, PAR_K + 1), torch.inf,
                                 device="cuda"), d], 1).contiguous()
    t = _select_case("ring_merge", cand, PAR_K + 1, None, False, exact=True)
    sel_timings["ring_merge"] = t
    del d, cand
    # the one-rank ring's merge: every point a query, the whole cloud a
    # block
    d = pairwise_sqdist(pts, pts).float()
    d.diagonal().fill_(-1.0)
    cand = torch.cat([torch.full((len(pts), PAR_K + 1), torch.inf,
                                 device="cuda"), d], 1).contiguous()
    del d
    sel_timings["ring_merge_1rank"] = _select_case(
        "ring_merge_1rank", cand, PAR_K + 1, None, False, exact=True)
    out["merge_calls"] = [t["call"], sel_timings["ring_merge_1rank"]["call"]]
    del cand
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dryrun_multichip(PAR_RANKS)     # its defaults: gloo ranks on the card
    out["dryrun_s"] = time.perf_counter() - t0
    print(json.dumps({"parallel_knn": out}), flush=True)
    return out


def phase_parallel_entry(card: str) -> dict:
    """train_point_seg --dp for one epoch of fold 0 on the one card: the
    single-rank path (the default run's widths)."""
    from fissure_segmentation_tpu_torch import train_point_seg
    with tempfile.TemporaryDirectory() as out:
        _par_zero()
        t0 = time.perf_counter()
        assert train_point_seg.main(
            DEFAULT_ARGV[:4] + ["--epochs", "1"] + DEFAULT_ARGV[6:]
            + ["--dp", "--train_only", "--output", out]) == 0
        hist = _read_history(os.path.join(out, "fold0", "history.csv"))
        if not (os.path.exists(os.path.join(out, "fold0", "model.pt"))
                and np.isfinite(hist).all()):
            raise AssertionError("train_point_seg --dp: no model or a "
                                 "non-finite loss")
        return {"card": card, "s": time.perf_counter() - t0,
                "loss": hist, "counts": _par_counts()}


def _par_sum(ranks: list, key: str) -> tuple:
    """The launches and calls of a path summed over the ranks."""
    launches, calls, roles = {}, {}, {}
    for r in ranks:
        n, c, ro = r[key]["counts"]
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        for k, d in c.items():
            for kk, v in d.items():
                calls.setdefault(k, {})[kk] = calls.setdefault(k, {}).get(
                    kk, 0) + v
        for k, d in ro.items():
            for kk, v in d.items():
                roles.setdefault(k, {})[kk] = roles.setdefault(k, {}).get(
                    kk, 0) + v
    return launches, calls, roles


def phases_parallel(card: str, sel_timings: dict) -> dict:
    """Phases 49-52 (inputs made here, then one spawn of two gloo ranks, of
    which rank 0 also runs the one-rank NCCL subgroup's paths); returns the
    launches by path and layout."""
    from fissure_segmentation_tpu_torch.parallel import spawn
    t0 = time.perf_counter()
    inp = _par_inputs(card)
    torch.cuda.empty_cache()
    t_in = time.perf_counter()
    ranks = spawn(_par_rank, PAR_RANKS, "gloo", "cuda:0", args=(inp,),
                  timeout_s=600.0)
    t_sp = time.perf_counter()
    gloo = [r["gloo2"] for r in ranks]
    nccl = [ranks[0]["nccl1"]]
    print(f"parallel: staged collectives under gloo on the card: "
          f"{gloo[0]['staged']}; under NCCL: {nccl[0]['staged']}; inputs "
          f"{t_in - t0:.1f} s, the spawn {t_sp - t_in:.1f} s (in rank 0: "
          f"gloo paths {ranks[0]['s']['gloo2']:.1f} s, NCCL paths "
          f"{ranks[0]['s']['nccl1']:.1f} s)", flush=True)
    single = _par_single(inp)
    res = {"train": phase_parallel_train(card, inp, gloo, nccl, single)}
    res["entry"] = phase_parallel_entry(card)
    res["ensemble"] = phase_parallel_ensemble(card, inp, gloo, nccl)
    res["window"] = phase_parallel_window(card, inp, gloo)
    res["knn"] = phase_parallel_knn(card, inp, gloo, nccl, sel_timings)
    paths = {}
    for layout, ranks in (("gloo2", gloo), ("nccl1", nccl)):
        for path in ("train", "ensemble", "window", "ring"):
            if path in ranks[0]:
                paths[f"{path}_{layout}"] = _par_sum(ranks, path)
    paths["entry_dp"] = res["entry"].pop("counts")
    res["paths"] = paths
    res["s"] = time.perf_counter() - t0
    return res


def par_kernel_checks(ks, knn_cuda, par_paths: dict, scatter: dict,
                      timings: dict) -> dict:
    """The kernels' calls on the parallel paths at shapes the earlier phases
    do not check, each held against its plain version at its shape and
    timed: the transpose, K3 (at the call's own payload type) and K4 on a
    K1 graph of the call's shape (`_time_scatter_at`), K1's and K2's calls
    (`slice_by_call`). K4's new calls are added to phase 6's `scatter`
    timings. Returns {"scatter": {call: timings}, "transposes": {call:
    timings}, "knn": by path and call, "scatter_rows": by path and call}."""
    def calls(name):
        out = {}
        for p in par_paths.values():
            for key, n in p[1].get(name, {}).items():
                out[key] = out.get(key, 0) + n
        return out
    timed = {}
    for key in calls("scatter_routed"):
        if f"path_{key}" not in scatter["scatter_routed"][1]:
            b, n, k, c = (int(v) for v in key.split("_")[0].split("x"))
            timed[key] = _time_scatter_at(
                ks, knn_cuda, b, n, k, c, 49 + b, "parallel",
                getattr(torch, key.rsplit("_", 1)[1]))
            scatter["scatter_count"][1].setdefault(
                f"ptr_{b}x{n}", timed[key]["scatter_count"])
    for key in calls("scatter_count"):
        if key not in scatter["scatter_count"][1]:
            b, n = (int(v) for v in key.removeprefix("ptr_").split("x"))
            timed[key] = _time_scatter_at(ks, knn_cuda, b, n, PAR_K, 64,
                                          49 + b, "parallel")
            scatter["scatter_count"][1][key] = timed[key]["scatter_count"]
    paths = {p: v[1] for p, v in par_paths.items()}
    return {"scatter": timed,
            "transposes": {t["transpose"]["call"]: t["transpose"]
                           for t in timed.values()},
            **{kind: {path: c for path, c in slice_by_call(
                kind, paths, shapes).items() if c}
               for kind, shapes in (("knn", timings),
                                    ("scatter_rows",
                                     scatter["scatter_rows"][1]))}}


# ---- phase 53: the fused EdgeConv tail and the last of the JAX package ----

TAIL_AB_RUNS = 3        # runs of each setting (on, off, off, on, on, off)
TAIL_AB_STEPS = 10      # warm steps (or ensemble forwards) a run
TAIL_F32_GRAD_TOL = 1e-3    # phase_tail_reference says why
TAIL_AB_NOISE = 0.01        # phase_tail_ab says why
FETCH_SHARE_LIMIT = 0.02    # the packed encodings' decision (ROADMAP)


def phase_tail_ab(ks, knn_cuda, card: str) -> dict:
    """53a: the tail's CUDA default and its A/B on the card. With
    FSEG_FUSED_EDGE_TAIL unset, `fused_tail_enabled("cuda")` must be
    `CUDA_TAIL_DEFAULT` and a default static step must call FusedEdgeTail
    (EdgeConv_0); then prof/tail_ab.py's cases, tail on against off
    (TAIL_AB_RUNS runs of TAIL_AB_STEPS each, CUDA events), the serving
    ensemble on the 256^3 case's Förstner keypoints. The default must be
    no slower than the other setting in any case. The A/B's launches are
    read (reset before, read after) and printed, not counted in the
    kernels line (an A/B, like phases 42 and 43's). The default must not
    be slower than the other setting by more than TAIL_AB_NOISE: in the
    train steps by the A/B's medians (device-bound: they moved 0.1-0.5 %
    from call to call on an H100), in the serving ensemble by its device
    time a forward (the profiler's kernels over 3 forwards): that forward
    is host-bound, and this late in the script its host time spreads
    +-30 % from run to run (46-76 ms a forward on an H100), so its
    A/B medians are printed, not held. prof/tail_ab.py's A/B in a fresh
    process (PERF.md) is what set the default."""
    from fissure_segmentation_tpu_torch import serving
    from fissure_segmentation_tpu_torch.models.blocks import FusedEdgeTail
    from fissure_segmentation_tpu_torch.ops.fused_edge import (
        CUDA_TAIL_DEFAULT, fused_tail_enabled)
    from fissure_segmentation_tpu_torch.prof.tail_ab import (CASES, ab,
                                                             build_cases)
    from fissure_segmentation_tpu_torch.utils.coords import kpts_to_grid
    saved = os.environ.pop("FSEG_FUSED_EDGE_TAIL", None)
    calls = []
    real = FusedEdgeTail.forward
    FusedEdgeTail.forward = lambda self, e: calls.append(1) or real(self, e)
    try:
        if fused_tail_enabled("cuda") != CUDA_TAIL_DEFAULT:
            raise AssertionError("tail: the CUDA default is not "
                                 "CUDA_TAIL_DEFAULT")
        case = synthetic_ct()
        vol = torch.as_tensor(case["image"], dtype=torch.float32,
                              device="cuda")
        mask = torch.as_tensor(case["lung_mask"], device="cuda").bool()
        with torch.no_grad():
            kpts, valid, shape = serving._keypoints(
                vol, mask, None, kp_mode="foerstner", max_kpts=20000,
                fissure_mu=0.0, fissure_sigma=1.0, cnn_model=None,
                cnn_dtype=None, kp_scores=None, approx_top_k=False)
            cloud = torch.where(valid[:, None], kpts_to_grid(
                kpts.flip(-1).to(torch.float32), shape), -1.0)
        with tempfile.TemporaryDirectory() as tmp:
            fns = build_cases(tmp, CASES, serving_cloud=cloud)
            fns["static f32"]()
            if bool(calls) != CUDA_TAIL_DEFAULT:
                raise AssertionError(f"tail: a default step made {len(calls)}"
                                     " FusedEdgeTail calls")
            _reset(ks, knn_cuda)
            res = {name: ab(fn, TAIL_AB_RUNS, TAIL_AB_STEPS, warm=2)
                   for name, fn in fns.items()}
            launches = {k: v for k, v in _counts(ks, knn_cuda).items() if v}
            host_bound = "serving f32"
            res[host_bound]["device_ms"] = dev = {}
            for flag in ("1", "0"):
                os.environ["FSEG_FUSED_EDGE_TAIL"] = flag
                dev["on" if flag == "1" else "off"] = _device_ms(
                    fns[host_bound], calls=2)
    finally:
        FusedEdgeTail.forward = real
        os.environ.pop("FSEG_FUSED_EDGE_TAIL", None)
        if saved is not None:
            os.environ["FSEG_FUSED_EDGE_TAIL"] = saved
    ratio = {n: r["on_over_off"] for n, r in res.items() if n != host_bound}
    ratio[host_bound] = dev["on"] / dev["off"]
    if not CUDA_TAIL_DEFAULT:
        ratio = {n: 1.0 / q for n, q in ratio.items()}
    slower = [n for n, q in ratio.items() if q > 1.0 + TAIL_AB_NOISE]
    if slower:
        raise AssertionError(f"tail: the default ({CUDA_TAIL_DEFAULT}) is "
                             f"slower in {slower}: {res}")
    for name, r in res.items():
        print(f"tail A/B {name}: on {r['on_median']:.3f} ms, off "
              f"{r['off_median']:.3f} ms ({r['on_over_off']:.4f}); runs on "
              f"{[round(t, 3) for t in r['on']]}, off "
              f"{[round(t, 3) for t in r['off']]} on {card}", flush=True)
    print(f"tail A/B: serving's device ms a forward {dev} (held; its host-"
          f"bound medians above are printed only); launches of the A/B (not "
          f"counted) {launches}", flush=True)
    return {"cases": res, "default": CUDA_TAIL_DEFAULT,
            "ab_launches": launches}


def _device_ms(fn, calls: int = 3) -> float:
    """The summed device time of the profiler's kernels a call of `fn`,
    over `calls` warm calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in device_rows(prof.key_averages())) / 1e3 / calls


def phase_tail_reference(card: str) -> dict:
    """53b: DGCNNSeg(k = 8, static) with the tail on both sides
    (FSEG_FUSED_EDGE_TAIL=1: the CPU's default is off), one train step on 4
    clouds of 256 points, card against CPU. float32 (the fused single-
    layer route, CUDA's default, on both sides): the loss within rtol 1e-5
    and the whole gradient within TAIL_F32_GRAD_TOL in relative L2, on the
    first input whose forward branches (LeakyReLU sides, maxima, routed
    slots) agree on both sides (phase_train_reference says why; it holds
    each leaf within 2e-4 there, 1e-3 as a whole allows a few leaves'
    rounding to add up); bf16 as phase 18 holds it (BF16_TOL)."""
    from fissure_segmentation_tpu_torch.models import export_jax_variables
    from fissure_segmentation_tpu_torch.train.trainer import TrainConfig
    saved = os.environ.get("FSEG_FUSED_EDGE_TAIL")
    os.environ["FSEG_FUSED_EDGE_TAIL"] = "1"
    os.environ["FSEG_FUSED_EDGE"] = "1"
    res = {}
    try:
        for seed in range(REF_SEEDS):
            ds, x, y, cw = _small_batch(530 + seed)
            model0 = _reference_model(seed, ds)
            m_g, l_g, _, br_g = _reference_step("cuda", model0, ds, cw,
                                                TrainConfig(), x, y)
            m_c, l_c, _, br_c = _reference_step("cpu", model0, ds, cw,
                                                TrainConfig(), x, y)
            if len(br_g) == len(br_c) and all(
                    torch.equal(a, b) for a, b in zip(br_g, br_c)):
                break
        else:
            raise AssertionError(f"tail reference: no input of {REF_SEEDS} "
                                 "took the same branches on both sides")
        _close("tail f32 loss", l_g, l_c, rtol=1e-5, atol=0)
        grad = _rel_l2(dict(_leaves(export_jax_variables(m_g, grad=True))),
                       dict(_leaves(export_jax_variables(m_c, grad=True))))
        if grad > TAIL_F32_GRAD_TOL:
            raise AssertionError(f"tail reference: f32 gradient {grad:.3g} "
                                 f"apart (tolerance {TAIL_F32_GRAD_TOL})")
        res["f32"] = {"seed": seed, "loss": [l_g, l_c], "grad_rel_l2": grad}
        ds, x, y, cw = _small_batch(539)
        model0 = _reference_model(0, ds, dtype=torch.bfloat16)
        m_g, l_g, _, _ = _reference_step("cuda", model0, ds, cw,
                                         TrainConfig(), x, y)
        m_c, l_c, _, _ = _reference_step("cpu", model0, ds, cw,
                                         TrainConfig(), x, y)
        _close("tail bf16 loss", l_g, l_c, rtol=BF16_TOL["loss"], atol=0)
        grad = _rel_l2(dict(_leaves(export_jax_variables(m_g, grad=True))),
                       dict(_leaves(export_jax_variables(m_c, grad=True))))
        stats = _rel_l2(*(dict(_leaves(export_jax_variables(m)[
            "batch_stats"])) for m in (m_g, m_c)))
        if grad > BF16_TOL["grad_rel_l2"] or \
                stats > BF16_TOL["stats_rel_l2"]:
            raise AssertionError(f"tail reference: bf16 gradient {grad:.3g},"
                                 f" statistics {stats:.3g} apart ({BF16_TOL})")
        res["bf16"] = {"loss": [l_g, l_c], "grad_rel_l2": grad,
                       "stats_rel_l2": stats}
    finally:
        os.environ.pop("FSEG_FUSED_EDGE")
        if saved is None:
            os.environ.pop("FSEG_FUSED_EDGE_TAIL")
        else:
            os.environ["FSEG_FUSED_EDGE_TAIL"] = saved
    print(f"tail reference: card vs CPU with the tail on both sides "
          f"{json.dumps(res)} on {card}", flush=True)
    return res


def phase_knn_chunk(card: str) -> dict:
    """53c: knn(query_chunk=) on the card equals the unchunked call,
    indices and distances: K1's route at (3, 8192, 3), kk = 30 (the
    serving normals' shape; K1 keeps no distance matrix, so the chunk
    changes nothing there), and the feature route at (2, 2048, 64) bf16,
    kk = 40, in chunks of 512 rows (each block's distances by the JAX
    formula, the fused row selection)."""
    from fissure_segmentation_tpu_torch.ops.knn import knn
    g = torch.Generator().manual_seed(53)
    out = {}
    for name, x, k, chunk in (
            ("k1_3x8192x3_kk30", torch.rand((3, 8192, 3), generator=g)
             * 2 - 1, 30, 1024),
            ("feature_2x2048x64_bf16_kk40",
             torch.randn((2, 2048, 64), generator=g).to(torch.bfloat16), 40,
             512)):
        x = x.cuda()
        whole = knn(x, k, self_loop=True, return_dist=True)
        part = knn(x, k, self_loop=True, return_dist=True,
                   query_chunk=chunk)
        if not (torch.equal(whole[0], part[0])
                and torch.equal(whole[1], part[1])):
            raise AssertionError(f"knn chunk {name}: the chunked selection "
                                 "differs from the unchunked one")
        out[name] = {"chunk": chunk, "equal": True,
                     "chunked_ms": median_ms(lambda: knn(
                         x, k, self_loop=True, query_chunk=chunk), reps=3,
                         inner=3),
                     "whole_ms": median_ms(lambda: knn(x, k, self_loop=True),
                                           reps=3, inner=3)}
    print(f"knn query_chunk on the card: {json.dumps(out)} on {card}",
          flush=True)
    return out


def phase_pt_bf16_reference(card: str) -> dict:
    """53d: PointTransformerSeg(dtype=bf16) at full depth and width, one
    train-mode forward and backward of sum(logits * w) on 2 clouds of 1024
    dyadic points (every kNN distance exact, so both sides select alike),
    card against CPU from the same weights: the logits and the whole
    gradient within 2 x the CPU's own bf16-vs-float32 distance (relative
    L2), the rule the CPU tests hold the bf16 model to against JAX's; and
    the eval-mode logits (running statistics: nothing amplifies rounding)
    within BF16_TOL["logits"] of their largest entry."""
    from fissure_segmentation_tpu_torch.models import (PointTransformerSeg,
                                                       export_jax_variables)
    g = torch.Generator().manual_seed(531)
    x = torch.randint(-16, 17, (2, 1024, 3), generator=g) / 16.0
    w = torch.randn((2, 1024, 4), generator=g)
    f32 = PointTransformerSeg(3, 4, generator=torch.Generator()
                              .manual_seed(532))
    runs = {}
    for name, dev, dtype in (("card", "cuda", torch.bfloat16),
                             ("cpu", "cpu", torch.bfloat16),
                             ("cpu_f32", "cpu", None)):
        model = PointTransformerSeg(3, 4, dtype=dtype)
        model.load_state_dict(f32.state_dict())
        model = model.to(dev).train()
        out = model(x.to(dev))
        (out * w.to(dev)).sum().backward()
        grads = dict(_leaves(export_jax_variables(model, grad=True)))
        runs[name] = (out.detach().float().cpu().numpy(), grads)
    rel = {"logits": lambda a, b: float(np.linalg.norm(a[0] - b[0])
                                        / np.linalg.norm(b[0])),
           "grad": lambda a, b: _rel_l2(a[1], b[1])}
    res = {k: {"card_vs_cpu": f(runs["card"], runs["cpu"]),
               "cpu_bf16_vs_f32": f(runs["cpu"], runs["cpu_f32"])}
           for k, f in rel.items()}
    for k, r in res.items():
        if not r["card_vs_cpu"] <= 2 * r["cpu_bf16_vs_f32"]:
            raise AssertionError(f"PointTransformer bf16 reference: {k} "
                                 f"{r}")
    model = PointTransformerSeg(3, 4, dtype=torch.bfloat16)
    model.load_state_dict(f32.state_dict())
    with torch.no_grad():
        lc = model.eval()(x).float()
        lg = model.cuda()(x.cuda()).float().cpu()
    res["eval_logits"] = float((lg - lc).abs().max() / lc.abs().max())
    if res["eval_logits"] > BF16_TOL["logits"]:
        raise AssertionError(f"PointTransformer bf16 reference: eval logits "
                             f"{res['eval_logits']:.3g} * max|logit| apart")
    print(f"PointTransformer bf16 reference: {json.dumps(res)} on {card}",
          flush=True)
    return res


def phase_fetch(card: str) -> dict:
    """53e: what the packed encodings would save. N_PIPE copies of the
    256^3 case through segment_cases (phase 4's model) with its stage
    timings: the fetch stage's median (the wait for a case's event: the
    rest of its device half and its copies) against the s/case; the bytes
    a case copies device -> host on the float path (the dispatched
    outputs), and those copies alone (CUDA events, into pinned buffers)
    against the s/case. The packed encodings are not to port if the copies
    take under FETCH_SHARE_LIMIT of a case."""
    from fissure_segmentation_tpu_torch.serving import (_device_case,
                                                        case_generator)
    case = synthetic_ct()
    vol = torch.from_numpy(case["image"]).cuda()
    mask = torch.from_numpy(case["lung_mask"]).cuda()
    apply = _serving_model(case)
    _serve_batch(vol, mask, apply, 5, True, n=2)         # warm-up
    _, s_case, tm = _serve_batch(vol, mask, apply, 0, True)
    fetch = statistics.median(t["fetch_s"] for t in tm)
    with torch.no_grad():
        out, _ = _device_case(
            vol, mask, apply, case_generator(0, 0), None, max_kpts=20000,
            sample_points=2048, n_runs_min=50, subset_batch=5,
            grid_res=(64, 64, 64), sig=4.0, k_normals=30, max_tris=24000,
            num_fg_classes=3, class_cap=8192, kp_mode="foerstner",
            fissure_mu=-313.5, fissure_sigma=62.6, cnn_model=None,
            cnn_dtype=None, kp_scores=None, approx_top_k=False)
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in out]
    n_bytes = sum(t.numel() * t.element_size() for t in out)

    def copies():
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)
    copy_ms = median_ms(copies, reps=5, inner=5)
    res = {"cases": N_PIPE, "s_per_case": s_case, "fetch_s_median": fetch,
           "fetch_share": fetch / s_case, "bytes_per_case": n_bytes,
           "copy_ms": copy_ms, "copy_share": copy_ms / 1e3 / s_case,
           "copy_gb_per_s": n_bytes / copy_ms / 1e6,
           "by_output": {name: t.numel() * t.element_size() for name, t in
                         zip(("kpts", "valid", "pred", "inside", "tris",
                              "n_tris"), out)}}
    res["packed_encodings"] = ("not to port"
                               if res["copy_share"] < FETCH_SHARE_LIMIT
                               else "port")
    print(f"fetch: {json.dumps(res)} on {card}", flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on an NVIDIA card", file=sys.stderr)
        return 2
    from fissure_segmentation_tpu_torch import train_point_seg
    # the entry's synthetic dataset, made once for every train_point_seg
    # run of the script (phases that cache it themselves keep doing so)
    with _cached_synthetic(train_point_seg):
        return _main()


def _main() -> int:
    from fissure_segmentation_tpu_torch import native
    from fissure_segmentation_tpu_torch.kernels import _build
    from fissure_segmentation_tpu_torch.kernels import scatter as ks
    from fissure_segmentation_tpu_torch.kernels.depthwise import (
        depthwise_conv3_cuda, depthwise_conv3_plain)
    from fissure_segmentation_tpu_torch.kernels.fps import fps_cuda, fps_plain
    from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda, knn_plain

    # 1. card and settings
    card = card_line()
    print(f"card: {card}", flush=True)
    # the card-vs-CPU phases hold the card against the CPU on one route:
    # the fused tail's, where it is CUDA's default (the CPU's is off), so
    # the CPU side takes it too (phase 53 checks the default itself)
    from fissure_segmentation_tpu_torch.ops.fused_edge import \
        CUDA_TAIL_DEFAULT
    os.environ["FSEG_FUSED_EDGE_TAIL"] = "1" if CUDA_TAIL_DEFAULT else "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    native.load()  # builds the C++ host runtime with g++; raises on failure
    print(f"native: {native.build()} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {_build.sources()} -> {lib} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. K1 against its plain version
    max_err, timings = phase_kernels(knn_cuda, knn_plain)

    # 4. the serving slice at full size (counts from 0, read after)
    _reset(ks, knn_cuda)
    serving = phase_slice(knn_cuda, card)
    gr_calls = [_gr_calls(ks, knn_cuda)]

    # 5. serving reference check on a small input
    phase_reference(card)

    # 6. K2-K4 against their plain versions
    scatter = phase_scatter(ks, knn_cuda)

    # 7. the training slice at full width (counts from 0, read after)
    counts, train_timing = phase_train(ks, knn_cuda, card)
    gr_calls.append(_gr_calls(ks, knn_cuda))
    print(json.dumps({"train": train_timing, "card": card}), flush=True)

    # 8. train-step reference on a small input
    phase_train_reference()

    # 9. K5 against its plain version
    fps_err, fps_timings = phase_fps(fps_cuda, fps_plain)

    # 10. the serving slice with PointTransformer (counts from 0, read after)
    _reset(ks, knn_cuda)
    pt_serving, pt_case_s = phase_pt_slice(card)

    # 11. the PointTransformer training slice (counts from 0, read after)
    pt_counts, pt_timing = phase_pt_train(ks, knn_cuda, card)
    print(json.dumps({"pt_train": pt_timing, "pt_case_s": pt_case_s,
                      "card": card}), flush=True)

    # 12. PointTransformer train-step reference on a small input
    phase_pt_reference()

    # 13. K6 against its plain version
    dw_err, dw_timings, dw_forward, dw_stride2 = phase_depthwise(
        depthwise_conv3_cuda, depthwise_conv3_plain)

    # 14. the serving slice in the cnn and enhancement keypoint modes
    # (counts from 0, read after)
    _reset(ks, knn_cuda)
    cnn_serving, cnn_timing = phase_cnn_slice(depthwise_conv3_cuda, card)
    gr_calls.append(phase_cnn_slice.gr_calls)
    print(json.dumps({"cnn_serving": cnn_timing, "k6_per_forward": dw_forward,
                      "k6_stride2": dw_stride2, "card": card}), flush=True)

    # 15. CNN reference, card against CPU, on a small input
    phase_cnn_reference()

    # 16. the fused gather-reduce against its plain version
    gr_err, gr_timings = phase_gather_reduce(knn_cuda)

    # 17. the bf16 training slice (counts from 0, read after)
    bf16_counts, bf16_timing = phase_bf16_train(ks, knn_cuda, card)
    gr_calls.append(_gr_calls(ks, knn_cuda))
    print(json.dumps({"bf16_train": bf16_timing, "card": card}), flush=True)

    # 18. bf16 train-step reference on a small input
    phase_bf16_reference()

    # 19. the probes of P1-P4 (the stream kernels' path, and K4's
    # histogram's: the launches of their timed calls)
    ks.scatter_count.calls.clear()
    probe_counts, probe_rows, stream_heads = phase_probes(card)
    if set(ks.scatter_count.calls) != {PROBE_K4_CALL}:
        raise AssertionError(f"probes: K4 calls {ks.scatter_count.calls}, "
                             f"not only {PROBE_K4_CALL}")
    print(json.dumps({"probes": probe_rows, "card": card}), flush=True)

    # 20. the default run of the entry point: dynamic bf16 training and
    # the test half (counts from 0, read after)
    default_counts, default_timing, default_gr, default_k4, default_sel = \
        phase_default_run(ks, knn_cuda, card)
    gr_calls.append(default_gr)
    print(json.dumps({"default_run": default_timing, "card": card}),
          flush=True)

    # 21. card against CPU on the default run's path, small input
    print(json.dumps({"dynamic_reference": phase_dynamic_reference(card),
                      "card": card}), flush=True)

    with tempfile.TemporaryDirectory() as slice_dir:
        # 22. the PC-AE entry at full width (counts from 0, read after)
        pcae_counts, pcae_timing, pcae_calls = phase_pcae(ks, knn_cuda, card,
                                                          slice_dir)
        print(json.dumps({"pcae": pcae_timing, "card": card}), flush=True)

        # 23. the PC-AE step, card against CPU, small input
        print(json.dumps({"pcae_reference": phase_pcae_reference(card),
                          "card": card}), flush=True)

        # 24. DSEG-AE on the card (counts from 0 after the seg fold's
        # training, read after its three runs)
        ae_dir = os.path.join(slice_dir, "ae_mesh")
        dseg_counts, dseg_timing, dseg_gr, dseg_calls = phase_dseg(
            ks, knn_cuda, card, ae_dir, slice_dir)
        gr_calls.append(dseg_gr)
        print(json.dumps({"dseg": dseg_timing, "card": card}), flush=True)

        # 25. DSEG-AE on one case, card against CPU
        print(json.dumps({"dseg_reference": phase_dseg_reference(
            card, os.path.join(slice_dir, "seg"), ae_dir), "card": card}),
            flush=True)
    slice_paths = {"pcae": pcae_calls, "dseg_ae": dseg_calls}

    # 26. K6's backward: the wgrad kernel and the dgrad against plain
    wg_err, wg_ratio, wg_timings, wg_step = phase_wgrad()

    # 27. the train_seg_cnn entry at full width (counts from 0 before each
    # run, read after it)
    with tempfile.TemporaryDirectory() as cnn_dir:
        cnn_paths, cnn_timing = phase_cnn_train(ks, knn_cuda, card, cnn_dir)
    print(json.dumps({"cnn_train": cnn_timing,
                      "k6_backward_per_v1_step": wg_step, "card": card}),
          flush=True)

    # 28. one train step of each CNN, card against CPU; the planted fault
    print(json.dumps({"cnn_train_reference": phase_cnn_train_reference(card),
                      "card": card}), flush=True)

    with tempfile.TemporaryDirectory() as family_dir:
        # 29. DPSR-Net at full width, v2 then v1 (counts from 0, read after)
        dpsr_counts, dpsr_timing, dpsr_calls, dpsr_gr, dpsr_k4 = phase_dpsr(
            ks, knn_cuda, card, family_dir)
        gr_calls.append(dpsr_gr)
        print(json.dumps({"dpsr": dpsr_timing, "card": card}), flush=True)

        # 30. DPSR-Net card against CPU, small input; the planted faults
        print(json.dumps({"dpsr_reference": phase_dpsr_reference(card),
                          "card": card}), flush=True)

        # 31. DG-SSM at full width (counts from 0, read after)
        dgssm_counts, dgssm_timing, dgssm_calls = phase_dgssm(
            ks, knn_cuda, card, family_dir)
        print(json.dumps({"dgssm": dgssm_timing, "card": card}), flush=True)

        # 32. a DG-SSM step card against CPU, small input
        print(json.dumps({"dgssm_reference": phase_dgssm_reference(card),
                          "card": card}), flush=True)
    slice_paths.update(dpsr=dpsr_calls, dgssm=dgssm_calls)
    # K3 and K4 at DPSR-Net's step shape, which phase 6 does not time
    dpsr_scatter = _time_dpsr_scatter(ks, knn_cuda)
    scatter["scatter_count"][1][dpsr_scatter["scatter_count"]["call"]] = \
        dpsr_scatter["scatter_count"]

    with tempfile.TemporaryDirectory() as pre_dir:
        # 33. process_case at 256^3, Förstner then cnn (counts from 0 before
        # each run, read after it)
        pre_counts, pre_calls, k6_calls, clouds, pre_timing = \
            phase_preprocess(ks, knn_cuda, card, pre_dir)
        print(json.dumps({"preprocess": pre_timing, "card": card}),
              flush=True)

        # 34. K1 and K6 at this slice's calls against their plain versions
        pre_k1, pre_k6, pre_k6_err = phase_preprocess_kernels(clouds,
                                                              k6_calls)
        del clouds
        torch.cuda.empty_cache()

        # 35. preprocess_dataset -> train_point_seg --data lobes -> the
        # lobes label space (counts from 0, read after)
        chain_counts, chain_calls, chain_gr, chain_k4, chain_timing = \
            phase_chain(ks, knn_cuda, card, pre_dir)
        gr_calls.append(chain_gr)
        print(json.dumps({"chain": chain_timing, "card": card}), flush=True)

        # 36. one case card against CPU
        print(json.dumps({"preprocess_reference": phase_preprocess_reference(
            card, pre_dir), "card": card}), flush=True)

        # 37 (its first run). PointNet on phase 35's MIND-SSC point files
        pn_features = phase_pointnet_features(
            card, os.path.join(pre_dir, "data"), pre_dir)
    slice_paths.update(preprocess=pre_calls["foerstner"],
                       preprocess_cnn=pre_calls["cnn"])
    timings.update(pre_k1)

    # 37. PointNet at full width: trained, tested, timed, served (counts
    # from 0, read after)
    with tempfile.TemporaryDirectory() as pn_dir:
        pn_counts, pn_calls, pn_timing = phase_pointnet(ks, knn_cuda, card,
                                                        pn_dir)
    pn_timing["mind_ssc"] = pn_features
    print(json.dumps({"pointnet": pn_timing, "card": card}), flush=True)

    # 38. PointNet card against CPU, f32 and bf16
    print(json.dumps({"pointnet_reference": phase_pointnet_reference(card),
                      "card": card}), flush=True)

    # 39. DGCNN with both stems, static and dynamic (counts from 0, read
    # after), then its bf16 step card against CPU
    with tempfile.TemporaryDirectory() as st_dir:
        st_counts, st_calls, st_gr, st_k4, st_timing = phase_stems(
            ks, knn_cuda, card, st_dir)
    gr_calls.append(st_gr)
    print(json.dumps({"stems": st_timing, "card": card}), flush=True)
    print(json.dumps({"stems_reference": phase_stems_reference(card),
                      "card": card}), flush=True)

    # 40. the affine experiments (counts from 0, read after), then a step
    # of each model card against CPU; K3 and K4 at their step's shapes
    with tempfile.TemporaryDirectory() as af_dir:
        af_counts, af_calls, af_gr, af_k4, af_k3, af_timing = phase_affine(
            ks, knn_cuda, card, af_dir)
    gr_calls.append(af_gr)
    print(json.dumps({"affine": af_timing, "card": card}), flush=True)
    print(json.dumps({"affine_reference": phase_affine_reference(card),
                      "card": card}), flush=True)
    affine_scatter = {c: _time_scatter_at(ks, knn_cuda, 8, 1024, 40, c,
                                          40 + c, "affine")
                      for c in (64, 128, 256)}
    scatter["scatter_count"][1]["ptr_8x1024"] = \
        affine_scatter[64]["scatter_count"]
    slice_paths.update(pointnet=pn_calls, stems=st_calls, affine=af_calls)

    # 41. the approximate top-k's kernels against their plain versions
    t41 = time.perf_counter()
    bin_timings, sel_timings = phase_approx_topk(card)

    # 42. segment_cases against a serial loop (counts from 0 before its
    # first pipelined run, read after it)
    t42 = time.perf_counter()
    pipe_counts, pipe_gr, pipe_timing = phase_pipeline(
        ks, knn_cuda, card)
    gr_calls.append(pipe_gr)
    print(json.dumps({"pipeline": pipe_timing, "card": card}), flush=True)

    # 43. the fast variant served, recall against exact, the bf16 CNN
    # (counts from 0 before its first timed pipelined run, read after it)
    t43 = time.perf_counter()
    fast_counts, fast_gr, (fast_bins, fast_sel), fast_timing = \
        phase_fast_serving(ks, knn_cuda, card)
    gr_calls.append(fast_gr)
    print(json.dumps({"fast_serving": fast_timing, "card": card}),
          flush=True)

    # 44. train_point_seg --knn_recall 0.9 (counts from 0, read after), the
    # steps with and without it, time_keypoint_extraction
    t44 = time.perf_counter()
    knn09_counts, knn09_gr, knn09_k4, knn09_sel, knn09_timing = \
        phase_knn_recall_train(ks, knn_cuda, card)
    gr_calls.append(knn09_gr)
    print(json.dumps({"knn_recall_train": knn09_timing, "card": card}),
          flush=True)

    # 45. corresponding points over 8 cases (counts from 0 before the
    # 'simple' run, read after it)
    t45 = time.perf_counter()
    corr_counts, corr_calls, corr_timing = phase_correspondences(
        ks, knn_cuda, card)
    print(json.dumps({"correspondences": corr_timing, "card": card}),
          flush=True)

    # 46. register_images through its entry at 256^3
    t46 = time.perf_counter()
    print(json.dumps({"register_images": phase_register(card),
                      "card": card}), flush=True)

    # 47. evaluate_baselines in both modes (counts from 0 before the two
    # runs, read after them)
    t47 = time.perf_counter()
    eb_counts, eb_calls, eb_k1, eb_timing = phase_baselines(ks, knn_cuda,
                                                            card)
    print(json.dumps({"baselines": eb_timing, "card": card}), flush=True)
    timings.update(eb_k1)

    # 48. the shape probes (counts from 0 before the DG-SSM toy, read
    # after it) and the plane fits
    t48 = time.perf_counter()
    shape_counts, shape_calls, shape_timing = phase_shape_probes(
        ks, knn_cuda, card)
    print(json.dumps({"shape_probes": shape_timing, "card": card}),
          flush=True)
    slice_paths.update(correspondences=corr_calls, baselines=eb_calls,
                       shape_probes=shape_calls)

    # 49-52. the parallel layer: data-parallel training, the sharded
    # ensemble, the z-slab window, the ring kNN and dryrun_multichip, on a
    # two-rank gloo group and a one-rank NCCL group on the card (each rank
    # counts from 0 before each of its paths and reads after), and
    # train_point_seg --dp (counts from 0, read after)
    t49 = time.perf_counter()
    par = phases_parallel(card, sel_timings)
    par_paths = par.pop("paths")
    par_counts = {k: sum(p[0].get(k, 0) for p in par_paths.values())
                  for k in counts["total"]}

    def par_calls(name):
        calls = {}
        for p in par_paths.values():
            for key, n in p[1].get(name, {}).items():
                calls[key] = calls.get(key, 0) + n
        return calls

    def par_row(name):
        return {path: p[0].get(name, 0) for path, p in par_paths.items()
                if p[0].get(name, 0)}
    gr_calls.append(par_calls("gather_reduce"))
    print(json.dumps({"parallel_launches": {
        path: {k: v for k, v in p[0].items() if v}
        for path, p in par_paths.items()}, "card": card}), flush=True)
    # 53. the fused tail's default and A/B (its launches read and printed,
    # not counted), the tail card against CPU, knn(query_chunk=), the bf16
    # PointTransformer card against CPU, the fetch stage and its copies
    t53 = time.perf_counter()
    tail = {"ab": phase_tail_ab(ks, knn_cuda, card),
            "reference": phase_tail_reference(card),
            "knn_query_chunk": phase_knn_chunk(card),
            "pt_bf16_reference": phase_pt_bf16_reference(card),
            "fetch": phase_fetch(card)}
    print(json.dumps({"tail_and_helpers": tail, "card": card}), flush=True)
    print(json.dumps({"phase_s": {
        "41": t42 - t41, "42": t43 - t42, "43": t44 - t43, "44": t45 - t44,
        "45": t46 - t45, "46": t47 - t46, "47": t48 - t47,
        "48": t49 - t48, "49-52": t53 - t49,
        "53": time.perf_counter() - t53}}), flush=True)

    def slice_row(name, timed):
        """The slice's launches of a kernel, by path and by call."""
        launches = {"pcae": pcae_counts[name], "dseg_ae": dseg_counts[name],
                    "dpsr": dpsr_counts[name], "dgssm": dgssm_counts[name],
                    "preprocess": pre_counts["foerstner"][name],
                    "preprocess_cnn": pre_counts["cnn"][name],
                    "pointnet": pn_counts[name], "stems": st_counts[name],
                    "affine": af_counts[name],
                    "correspondences": corr_counts[name],
                    "baselines": eb_counts[name],
                    "shape_probes": shape_counts[name]}
        row = {"launches": launches}
        if name in ("knn", "scatter_rows", "fps"):
            row["by_call"] = slice_by_call(name, slice_paths, timed)
        return row

    # the chain's train_point_seg run counts with the train paths, like the
    # default run (its widths), and so do phase 39's DGCNN runs with both
    # stems
    train_total = {k: counts["total"][k] + bf16_counts[k] + default_counts[k]
                   + chain_counts[k] + st_counts[k] + knn09_counts[k]
                   for k in counts["total"]}
    # phases 42 and 43 serve through K1, the gather-reduce and the bin
    # kernel
    serve_total = {k: pipe_counts[k] + fast_counts[k] for k in pipe_counts}
    # K4 by call: the train paths' count_from_ptr, the probes' histogram at
    # 512 rows (the launches of their timed calls)
    k4_calls, k4_paths = {}, {}
    for path, part in (("train", counts["k4_calls"]),
                       ("train", bf16_counts["k4_calls"]),
                       ("train", default_k4), ("dpsr", dpsr_k4),
                       ("train", chain_k4), ("train", st_k4),
                       ("affine", af_k4), ("train", knn09_k4),
                       ("parallel", par_calls("scatter_count"))):
        for key, n in part.items():
            k4_calls[key] = k4_calls.get(key, 0) + n
            if path != "parallel" or key not in k4_paths:
                k4_paths[key] = path
    if probe_counts.get("scatter_count", 0) < 1:
        raise AssertionError("scatter_count: the probes never launched "
                             "the histogram")
    k4_calls[PROBE_K4_CALL] = probe_counts["scatter_count"]
    k4_paths[PROBE_K4_CALL] = "probes"
    par_checked = par_kernel_checks(ks, knn_cuda, par_paths, scatter,
                                    timings)
    if sum(k4_calls.values()) != (train_total["scatter_count"]
                                  + probe_counts["scatter_count"]
                                  + dpsr_counts["scatter_count"]
                                  + af_counts["scatter_count"]
                                  + par_counts["scatter_count"]):
        raise AssertionError(f"scatter_count: {k4_calls} by call against "
                             f"{train_total['scatter_count']} train, "
                             f"{probe_counts['scatter_count']} probe and "
                             f"{dpsr_counts['scatter_count']} DPSR-Net "
                             f"and {af_counts['scatter_count']} affine "
                             "launches")
    graph = timings["dgcnn_graph_5x2048x3_k40"]
    kernels = [{
        "name": "knn", "route": "cuda", "source": KNN_SOURCE,
        "replaces": KNN_REPLACES,
        "launches": serving["knn"] + train_total["knn"]
        + pt_serving["knn"] + pt_counts["knn"] + cnn_serving["knn"]
        + pcae_counts["knn"] + dseg_counts["knn"] + dpsr_counts["knn"]
        + dgssm_counts["knn"] + pre_counts["foerstner"]["knn"]
        + pre_counts["cnn"]["knn"] + pn_counts["knn"] + af_counts["knn"]
        + serve_total["knn"] + eb_counts["knn"] + shape_counts["knn"]
        + par_counts["knn"],
        "max_abs_err": max_err, "ms": graph["ms"],
        "plain_ms": graph["plain_ms"], "bound_ms": graph["bound_ms"],
        "bound_by": graph["bound_by"], "library_ms": None,
        "slice": slice_row("knn", timings),
        "parallel": {"launches": par_row("knn"),
                     "by_call": par_checked["knn"]},
        "shapes": timings}]
    tr_path = next(iter(scatter["transpose"][1].values()))
    for name, (err, shapes) in scatter.items():
        path = next(iter(shapes.values()))       # the first timed shape
        row = {"name": name, "route": "cuda", "source": SCATTER_SOURCE,
               "replaces": SCATTER_REPLACES[name],
               "launches": train_total[name] + pcae_counts[name]
               + dseg_counts[name] + dpsr_counts[name]
               + dgssm_counts[name] + af_counts[name] + serve_total[name]
               + shape_counts[name] + par_counts[name],
               "max_abs_err": err,
               "ms": path["ms"], "plain_ms": path["plain_ms"],
               "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
               "library_ms": path["library_ms"], "shapes": shapes}
        if name in ("transpose", "scatter_rows"):
            row["also_replaces"] = [f"{PALLAS_SCATTER}:133"]
        if name == "transpose":   # built for K2 and K3 alike
            row["also_replaces"].append(SCATTER_REPLACES["scatter_routed"])
        if name in ("transpose", "scatter_rows"):
            row["slice"] = slice_row(name, shapes)
        row["parallel"] = {"launches": par_row(name),
                           "calls": par_calls(name)}
        if name == "scatter_rows":
            row["parallel"]["by_call"] = par_checked["scatter_rows"]
        if name == "transpose":   # no calls dict: checked at each graph
            row["parallel"]["checked_at"] = par_checked["transposes"]
        if name in ("scatter_rows", "scatter_routed"):
            # "ms" builds its own transpose; "shared_ms" is given one
            row.update(shared_ms=path["shared_ms"],
                       transpose_ms=tr_path["ms"],
                       transpose_bound_ms=tr_path["bound_ms"])
        if name == "scatter_routed":
            # by call: the DGCNN train paths' (32, 2048, 40, 64) and
            # DPSR-Net's (32, 1024, 20, 64)
            new = dpsr_scatter["scatter_routed"]
            row["by_call"] = {
                next(iter(shapes)): {
                    "launches": row["launches"] - dpsr_counts[name]
                    - af_counts[name] - serve_total[name]
                    - par_counts[name],
                    **{k: path[k] for k in ("ms", "shared_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}},
                new["call"]: {"launches": dpsr_counts[name],
                              **{k: v for k, v in new.items()
                                 if k != "call"}}}
            # the affine DGCNN's EdgeConvs, (8, 1024, 40, C), by call
            timed = {t["scatter_routed"]["call"]: t["scatter_routed"]
                     for t in affine_scatter.values()}
            if set(af_k3) - set(timed) or \
                    sum(af_k3.values()) != af_counts[name]:
                raise AssertionError(f"scatter_routed: affine calls {af_k3} "
                                     f"against {sorted(timed)}")
            for key, n in af_k3.items():
                row["by_call"][key] = {
                    "launches": n, "path": "affine",
                    **{k: v for k, v in timed[key].items() if k != "call"}}
            # the parallel paths' calls, each checked and priced at its
            # shape and payload type: phase 6's or the one timed above
            for key, n in par_calls(name).items():
                t = shapes.get(f"path_{key}") or \
                    par_checked["scatter"][key]["scatter_routed"]
                row["by_call"][f"{key} (parallel)"] = {
                    "launches": n, "path": "parallel",
                    **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
        if name == "scatter_count":
            # priced by call; the top-level numbers are the most launched
            # call's (the train step's count_from_ptr)
            by_call = k4_by_call(k4_calls, shapes, k4_paths)
            print(json.dumps({"scatter_count_by_call": by_call}), flush=True)
            top = by_call[max(k4_calls, key=k4_calls.get)]
            row.update({k: top[k] for k in ("ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")},
                       launches=sum(k4_calls.values()), by_call=by_call,
                       gap_ms=sum(r["gap_ms"] for r in by_call.values()))
        kernels.append(row)
    step = fps_timings["pt_step_32x2048x3_m512"]
    kernels.append({
        "name": "fps", "route": "cuda", "source": FPS_SOURCE,
        "replaces": FPS_REPLACES,
        "launches": pt_serving["fps"] + pt_counts["fps"] + dseg_counts["fps"]
        + corr_counts["fps"] + par_counts["fps"],
        "max_abs_err": fps_err, "ms": step["ms"],
        "plain_ms": step["plain_ms"], "bound_ms": step["bound_ms"],
        "bound_by": step["bound_by"], "library_ms": None,
        "slice": slice_row("fps", fps_timings), "shapes": fps_timings})
    widest = dw_timings["b4_1x128x128x128x192"]
    train_widest = wg_timings["v1_b4_32x48x48x48x192"]
    train_s2 = wg_timings["v1_b5_s2_32x48x48x48x192"]
    k6_paths = {"serving_cnn": {"forward": cnn_serving["depthwise_conv3"],
                                "dgrad": 0},
                **{p: {"forward": v["forward"], "dgrad": v["dgrad"]}
                   for p, v in cnn_paths.items()},
                "preprocess_cnn": {
                    "forward": pre_counts["cnn"]["depthwise_conv3_forward"],
                    "dgrad": 0},
                "parallel_window": {
                    "forward": par_paths["window_gloo2"][2][
                        "depthwise_conv3"]["forward"],
                    "dgrad": par_paths["window_gloo2"][2][
                        "depthwise_conv3"]["dgrad"]}}
    s2_paths = {"serving_cnn": cnn_serving["depthwise_conv3_stride2"],
                **{p: v["stride2"] for p, v in cnn_paths.items()},
                "preprocess_cnn": pre_counts["cnn"]["depthwise_conv3_stride2"],
                "parallel_window": par_paths["window_gloo2"][2][
                    "depthwise_conv3"]["stride2"]}
    serve_s2 = dw_stride2["s2_b5_1x128x128x128x192"]
    kernels.append({
        "name": "depthwise_conv3", "route": "cuda", "source": DW_SOURCE,
        "replaces": f"{PALLAS_DW}:200", "also_replaces": f"{PALLAS_DW}:171",
        "launches": sum(v["forward"] + v["dgrad"] for v in k6_paths.values()),
        "by_path": k6_paths, "max_abs_err": max(dw_err, pre_k6_err),
        "ms": widest["ms"], "plain_ms": widest["plain_ms"],
        "bound_ms": widest["bound_ms"], "bound_by": widest["bound_by"],
        "library_ms": widest["library_ms"], "per_forward": dw_forward,
        "dgrad_at_v1_b4_32x48x48x48x192": {
            k: train_widest[f"dgrad_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "preprocess_cnn_calls": pre_k6, "shapes": dw_timings})
    kernels.append({
        "name": "depthwise_conv3_stride2", "route": "cuda",
        "source": DW_SOURCE,
        # no TPU kernel: the JAX package computes the stride-2 layers with
        # XLA's grouped convolution (and lraspp_3d.py:66)
        "replaces": "fissure_segmentation_tpu/models/seg_cnn.py:53",
        "launches": sum(s2_paths.values()), "by_path": s2_paths,
        "max_abs_err": dw_err, "ms": serve_s2["ms"],
        "plain_ms": serve_s2["plain_ms"], "bound_ms": serve_s2["bound_ms"],
        "bound_by": serve_s2["bound_by"],
        "library_ms": serve_s2["library_ms"],
        "dgrad_at_v1_b5_32x48x48x48x192": {
            k: train_s2[f"dgrad_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "stuff_ms_at_v1_b5": train_s2["stuff_ms"],
        "shapes": dw_stride2})
    kernels.append({
        "name": "depthwise_wgrad", "route": "cuda", "source": DW_SOURCE,
        # no TPU kernel: the JAX package trains these layers with XLA's
        # gradient of its grouped convolution
        "replaces": "fissure_segmentation_tpu/models/seg_cnn.py:53",
        "launches": sum(v["wgrad"] for v in cnn_paths.values()),
        "by_path": {p: {"all": v["wgrad"], "stride2": v["wgrad_stride2"]}
                    for p, v in cnn_paths.items()},
        "max_abs_err": wg_err, "max_err_over_bound": wg_ratio,
        "ms": train_widest["wgrad_ms"],
        "plain_ms": train_widest["wgrad_plain_ms"],
        "bound_ms": train_widest["wgrad_bound_ms"],
        "bound_by": train_widest["wgrad_bound_by"],
        "library_ms": train_widest["wgrad_library_ms"],
        "stride2_at_v1_b5_32x48x48x48x192": {
            k: train_s2[f"wgrad_{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "per_v1_step": wg_step, "shapes": wg_timings})
    # the gather-reduce priced by call: the main path's launches of each
    # (want, dtype, shape) at that call's own time and bound; the top-level
    # numbers are those of the call with the most launches
    calls = {}
    for part in gr_calls:
        for key, n in part.items():
            calls[key] = calls.get(key, 0) + n
    by_call = gr_by_call(calls, gr_timings)
    top = gr_timings[max(calls, key=calls.get)]
    print(json.dumps({"gather_reduce_by_call": by_call}), flush=True)
    gr_launches = (serving["gather_reduce"] + train_total["gather_reduce"]
                   + cnn_serving["gather_reduce"]
                   + dseg_counts["gather_reduce"]
                   + dpsr_counts["gather_reduce"]
                   + af_counts["gather_reduce"]
                   + serve_total["gather_reduce"]
                   + par_counts["gather_reduce"])
    if sum(calls.values()) != gr_launches:
        raise AssertionError(f"gather_reduce: {gr_launches} launches but "
                             f"{calls} by call")
    kernels.append({
        "name": "gather_reduce", "route": "cuda", "source": GR_SOURCE,
        "replaces": GR_REPLACES, "launches": gr_launches,
        "max_abs_err": gr_err, "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "old_ms": top.get("old_ms"),
        "by_call": by_call, "slice": slice_row("gather_reduce", {}),
        "parallel": {"launches": par_row("gather_reduce"),
                     "calls": par_calls("gather_reduce")},
        "gap_ms": sum(r["gap_ms"] for r in by_call.values()),
        "shapes": gr_timings})
    det = bin_timings["detector_uniform_f32"]
    kernels.append({
        "name": "approx_topk_bins", "route": "cuda",
        "source": APPROX_SOURCE, "replaces": APPROX_REPLACES,
        "no_tpu_kernel": "XLA's ApproxTopK behind lax.approx_max_k",
        "also_replaces": APPROX_ALSO[:1],
        "launches": fast_counts["bin_extrema"] + knn09_counts["bin_extrema"],
        "by_path": {"fast_serving": fast_counts["bin_extrema"],
                    "knn_recall_train": knn09_counts["bin_extrema"]},
        "max_abs_err": 0.0, "ms": det["ms"], "warm_ms": det["warm_ms"],
        "plain_ms": det["plain_ms"], "bound_ms": det["bound_ms"],
        "bound_by": det["bound_by"], "library_ms": det["library_ms"],
        "library": det["library"], "aggregate_ms": det["aggregate_ms"],
        "by_call": _bins_by_call(fast_bins, bin_timings),
        "shapes": bin_timings})
    # the fused row selection: the approximate graphs and every exact
    # feature graph on the card, by path; by call where the path records
    # its calls (the default run, fast serving, the --knn_recall run)
    sel_paths = {"train": train_total["select_rows"],
                 "pcae": pcae_counts["select_rows"],
                 "dseg_ae": dseg_counts["select_rows"],
                 "dpsr": dpsr_counts["select_rows"],
                 "dgssm": dgssm_counts["select_rows"],
                 "preprocess": pre_counts["foerstner"]["select_rows"],
                 "preprocess_cnn": pre_counts["cnn"]["select_rows"],
                 "pointnet": pn_counts["select_rows"],
                 "affine": af_counts["select_rows"],
                 "serving": serve_total["select_rows"],
                 "parallel": par_counts["select_rows"]}
    sel_calls = {}
    for part in (default_sel, fast_sel, knn09_sel,
                 par_calls("select_rows")):
        for key, n in part.items():
            sel_calls[key] = sel_calls.get(key, 0) + n
    sel_by_call = _select_by_call(sel_calls, sel_timings)
    top = sel_by_call[max(sel_calls, key=sel_calls.get)]
    kernels.append({
        "name": "approx_topk_select", "route": "cuda",
        "source": APPROX_SOURCE, "replaces": SELECT_REPLACES,
        "no_tpu_kernel": "XLA's ApproxTopK behind lax.approx_min_k and "
                         "lax.top_k",
        "also_replaces": SELECT_ALSO,
        "launches": sum(sel_paths.values()), "by_path": sel_paths,
        "max_abs_err": 0.0, "call": top["call"],
        **{k: top[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "old_path_ms")},
        "library": "torch.topk (exact)", "by_call": sel_by_call,
        "shapes": sel_timings})
    for name, head in stream_heads.items():
        kernels.append({
            "name": name, "route": "cuda", "source": STREAM_SOURCE,
            "replaces": STREAM_REPLACES[name],
            "also_replaces": STREAM_ALSO[name], "path": "probes",
            "launches": probe_counts.get(name, 0), **head})
    for row in kernels:
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']} never launched on the main "
                                 "paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
