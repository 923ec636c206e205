"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits nonzero without the final
``{"ok": true, ...}`` line):

1. Require CUDA; print the card's name and power limit (nvidia-smi), and the
   torch and CUDA versions. TF32 is switched off for matmuls and cuDNN.
   Every synthetic frame of the later phases is rendered here, on the card
   (dataio/synthetic.render_views: the numpy renderer's arithmetic in
   float32, a few pixels of a frame one grey level apart from it), before
   anything is timed.
2. Build the kernels from ``orb_slam2_with_comment_tpu_torch/csrc``
   (``hamming.cu``, the package's first kernel ``hamming_v1.cu`` as the
   timing baseline, ``pose_lm.cu``, the first pose kernel
   ``pose_lm_v1.cu`` as its timing baseline, ``orb.cu``, and PR 10's
   ``orb_cells`` and ``orb_describe`` as ``orb_v1.cu``, their timing
   baseline, ``stereo_sad.cu``, K5's first design ``stereo_sad_v1.cu``
   as its timing baseline, ``ba.cu`` and ``ba_v1.cu``; one nvcc each, started
   together) and print the build time, ptxas' register report, the
   blocks of ``orb_cells`` and ``orb_describe`` resident on one SM,
   current and baseline (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
   From
   here on every feature extraction counts one frame and every view
   extracted on the card one view (count_frames): the launches per frame
   of each path.
3. Hold both kernel entry points against their plain PyTorch versions on the
   card, bit-exact: random 30% masks with ties, an all-masked and an
   all-admissible row at [300,257], [1000,1000], [8000,1000], [1024,8000]
   (the duplicate-landmark merge's grid), [4096,1000] (the loop closer's
   projection searches), [4096,2000] (the monocular local-map search),
   [2000,2000], [1241,999] (an odd row pitch), [37,1] and [1,5];
   stereo-like row-band masks (about 1% admissible) at [1000,1000],
   [2000,2000] and [1241,999]; an all-false and an all-true mask;
   descriptors that start off a 16-byte boundary; the monocular
   initialization window mask (100 px, level-0 features) of the first two
   orbit frames at [2000,2000]. The baseline
   kernel is held to the same results. Then time the kernel, the baseline
   kernel and the plain version at the main path's shapes: per wrapper call
   with CUDA events (the host's launch cost included) and per launch
   inside a replayed CUDA graph (the device's time alone), beside the
   bound computed from each problem's bytes and admissible pairs.
   Then K3, the pose LM kernel (csrc/pose_lm.cu), against
   optimize_pose_plain on the card (hold_pose): random problems with 10%
   gross outliers at [B,N] = [3,1000], [1,1000], [3,2000], [1,2000],
   [1,4096], [3,4096] and [1,16384] (above the baseline kernel's 7680
   edges), at [3,100] (one block a pose), at [3,896] and [3,897] (7 and 8
   blocks a pose on the same work), and every case of tests/test_torch_pose_lm.py at [3,1000]
   (dataio.synthetic.pose_problem): inlier masks and counts identical, R
   and t within 1e-4, chi2 within 1e-3 relative, two launches bit for
   bit; the baseline kernel (csrc/pose_lm_v1.cu) on the same problems (up to
   7680 edges) held to the same gates, and to the kernel's bits where the
   kernel gives a pose one block; both timed in turns the same two ways
   beside the bound (the baseline kernel's float32 operation count over
   67 TFLOP/s, or the bytes) and the plain version's time.
   Then K2, ORB extraction (csrc/orb.cu), kernel by kernel against its
   plain version on the same inputs (hold_orb), and the chain against the
   plain chain: two orbit frames at 640x480 with 1000 and 2000 features, a
   KITTI-camera frame at 1241x376 with 2000, an odd size (641x479: ragged
   cells on every level), a flat image (no corner, every slot invalid), a
   checkerboard (many equal scores), 50 features and 5 (levels of budget
   0), two frames above the former 2048-cell limit: 1921x1081 and
   2560x1440 with 1000 features, and orbit frame 0's pyramid less 128
   with some -0 pixels (orb_cells scores tiles with a sign bit set on the
   floats, the others on the bits). The score and blurred buffers, the
   candidates, yx, response, valid,
   octave and xy identical on every slot (the baseline kernels'
   orb_cells, csrc/orb_v1.cu, gives the current one's buffers and
   candidates too, and its orb_describe is held to the same gates); angles identical on level 0 and
   within 1e-4 on coarser levels wherever the IC moments keep 1/1000 of
   their terms' magnitude (where they cancel, on flat patches and at
   symmetric checkerboard junctions, the angle is rounding in either
   version: reported, not held); descriptors identical wherever the angles
   are, and on the rendered frames at most 1% of the valid rows differing,
   by at most 8 bits; two launches identical. Each kernel is timed at the
   main path's three shapes and at 2560x1440 the same two ways beside its
   bound (bound_orb) and its plain version's time, orb_cells and
   orb_describe in turns with their baseline kernels (both sides through
   ops/orb.launch_cells and launch_describe, so that the two times differ
   only by the kernel), and the chain per
   view beside the plain chain and the pyramid before it.
   Then K5, the stereo match after the association (csrc/stereo_sad.cu:
   the SAD refinement of every level, the depth and the median-SAD sweep
   in one cooperative launch), against stereo_depth_plain (hold_sad) on
   the main path's inputs (K1's association of the extracted views): the
   rendered bench pair (640x480, 1000 features), the KITTI-camera pair
   (1241x376, 2000), an odd size (641x479), 5 features (levels of budget
   0), the bench pair with a fifth of the keypoints on the image border
   and a fifth of the coarse right u off either side, the bench pair with
   every best_d >= 75 (no good keypoint: the median is inf), the KITTI
   pair at 4096 features, and the bench pair with ties at the median (one
   good keypoint of each level copied into 2 of every 3 of its slots):
   u_right and depth in bits, the best SAD, ok and the best shift in bits
   against sad_refine_plain, two launches in bits; the first design
   (csrc/stereo_sad_v1.cu, the refinement alone) held to the plain
   refinement as before (the best shift and ok identical except at
   near-ties, u within 1e-4 px). Both timed the same two ways in turns
   (new, first design, first design, new) beside the bound, the plain
   version and the parent's path after K1 (the first design and the eager
   tail); the kernel's stamps split its time between the refinement with
   the per-keypoint tail and the median's sweep.
   Then K4, the dense BA (csrc/ba.cu: one ba_solve launch a solve, the
   reduced system's Cholesky factorization inside), against
   ba_solve_plain (hold_ba) on random local-BA problems
   (dataio.synthetic.ba_problem) at P = 24 / L = 8192 (the factorization
   in shared memory), P = 64 / L = 10,000 (from global memory), P = 8
   with accept_all, P = 2 over 20 iterations: one launch a solve; the
   first S and b_s within 1e-5 of max |S| (or twice the plain float32
   system's distance from float64); the first step within n kappa 2^-52
   of a float64 torch.linalg.solve of the kernel's own float64 S; the
   accept sequence identical wherever |chi2_new / chi2_old - 1| > 1e-5
   and R, t and X within 1e-4 where float32 resolves the problem (the
   plain float32 solve within 1e-4 of a float64 one; elsewhere reported),
   the final damping equal where the sequences are (else the one the
   kernel's sequence leads to), chi2 within 1e-3 relative, two solves bit
   for bit; the solve timed the same two ways beside its bound, PR 13's
   kernels (csrc/ba_v1.cu with torch.linalg.solve_ex, in turns) and
   ba_solve_plain, each phase's ms from the kernel's stamps, and
   torch.linalg.solve_ex on the same float64 S beside the factorize
   phase. The dense BA problems phases 4 and 9-11 give the solver
   (captured_problems) join them after those phases. Every solve hold_ba
   holds also counts the iterations whose float64 accept decision a
   float32 comparison of the same two chi2s (the JAX package's test)
   would not take (ACCEPT_TEST, logged at the end).
   Then every kernel beyond its first variant's shapes (check_variants),
   each a row of the kernels line: K4 at P 24 / L 8192 with 48 and 64
   slots, the observations spread over every slot (the wide variant,
   hold_ba); K3 at [1,65536] and [3,65536] (a cluster of 16 blocks) and
   [1,131072] (the edges from global memory; hold_pose); K2 at 24 levels
   (the table in device memory), with 30 px cells, 24 levels of 30 px
   cells and 16 px cells of 4 (orb_cells_any, the pair read from the
   table) and with 140,000 features at 2560x1440 (orb_select through global
   scratch): candidates and selection bit for bit, hold_describe's gates,
   the chain against the plain chain and twice in bits; K5 at 24 levels
   of the KITTI pair and of the bench pair with a 4 px margin (levels
   under 11 rows, their reads clamped), in bits against its plain
   version; K1 at [4,4194321] (the 64-bit key), bit-exact. Each timed
   beside its bound and its plain version.
4. Run the RGB-D slice at the bench configuration (640x480, 1000 features,
   MapConfig(24, 1000, 8000, 8), loop_closing=False) over the 60-frame
   synthetic orbit, then re-track its first 30 frames once more (the whole
   orbit before the stereo phases came; cut to keep the run's time);
   assert initialization, no loss, every frame of both passes valid, the
   keyframe count, the pose error against ground truth, that both K1
   entry points were launched and K3 at least twice per tracked frame.
5. Run a 16-frame reduced-size slice on the card and on the CPU (plain
   versions) and compare keyframe decisions and poses.
6. The default tracker, AutoTrackerConfig() (loop closing and
   relocalization on), at the bench configuration: the 60-frame orbit,
   3 black frames, then frames 2-4 again. Every build frame valid, the
   black frames invalid, the first revisit frame relocalized (stats column
   6 == 2) within 0.05 m of ground truth, not lost at the end, and no loop
   closed (the JAX package closes none on this sequence on the CPU: the
   orbit has no loop to close). Both kernels launch on the relocalization
   frame. Prints the tracker's build time (vocabulary load and the
   forward-mode AD warm-up), the ms of the frames that ran the
   loop-closing phase and
   of the relocalization frame, by stage on that first call and on a
   second call from the same state and random draws.
7. A controlled loop at full width (tests/test_auto_loop.py's scenario):
   640x480, 1000 features, MapConfig(20, 1000, 10000, 8), a 14-frame lap
   plus 4 frames, drift injected into the poses the map is told for
   keyframes 8-13, driven through keyframe_step + close_loop_step. A loop
   fires at a keyframe >= 10, the corrected keyframe's error falls below
   0.35 of its error before, keyframe 0 stays within 1e-3 m. Prints the ms
   of the close_loop_step that fires, by stage on that first call and on a
   second call from the same input and random draws.
8. Slot compaction with loop closing on, every frame valid and median
   error < 0.02 m: the landmark-pressure configuration of
   tests/test_auto.py (MapConfig(12, 1000, 2500, 8), the 40-frame orbit)
   compacts landmarks (n_compact_lm >= 1); the first 40 frames of the
   60-frame orbit with 2% depth noise (SyntheticWorld(seed=1,
   depth_noise=0.02)) at MapConfig(12, 1000, 8000, 8) compact keyframes
   (n_compact_kf >= 1). The noise keeps the tracked share low, so a
   keyframe is inserted at nearly every early frame, maintenance culls a
   redundant one, and the insert at frame 33 recycles its slot. The JAX
   package does the same on the CPU: inserts at frames 0-4, 6, 7, 9, 12,
   13, 16, 21 and 33, n_compact_kf = 1, median error 4.7 mm.
9. Stereo at the bench configuration (bench.py's stereo figure): 640x480,
   1000 features, bf = 40, fx = 500, MapConfig(24, 1000, 8000, 8), the
   60-frame orbit with the right view rendered at the 8 cm baseline, the
   default AutoTrackerConfig(), built, then its first 10 frames again
   with stage timers (phase 17 re-tracks the figure and holds the
   re-tracking passes to these checks). Initialized, never lost, every
   frame valid,
   at least 3 keyframes, median translation error < 0.03 m, more than 200
   features with depth on frame 0, one ``masked_best_two`` launch by the
   stereo association in every frame of the build pass, at least one
   launch per frame
   more than the default RGB-D tracker of phase 6 made over the same 60
   poses, and at least two K3 launches per tracked frame (phase 10 too).
   Prints ms per frame and the stage times of the front end: both
   views' extraction, ``match_stereo`` and its ``_stereo_depth`` part.
10. Stereo at the KITTI 00-02 camera (bench.py's KITTI-shape figure):
   1241x376, 2000 features, fx = fy = 718.856, cx = 607.1928,
   cy = 185.2157, bf = 386.1448, MapConfig(24, 2000, 8000, 8), fps = 10,
   30 frames, built, then the first 10 again with stage timers.
   Initialized, not lost, every frame valid. Prints the same times
   and ``trajectory_kitti()``'s line count. (The scene stays well tracked
   from the first keyframe, so this run inserts no second one and its only
   kernel is ``masked_best_two``.)
11. Monocular at the bench configuration (bench.py's mono figure): 640x480,
   2000 features, min_init_features=200, min_init_matches=60,
   MapConfig(24, 2000, 8000, 8), fps=30, the default AutoTrackerConfig(),
   the 60 images of the orbit, one pass (phase 17 re-tracks the same
   configuration as the bench's mono figure). Initialized, never lost,
   every frame after the bootstrap frame valid, at least 3 keyframes,
   similarity-aligned (scale + SE3) ATE below 0.03 m, the median scene
   depth of keyframe 0 equal to 1 within 1e-3 right after the bootstrap,
   ``masked_best_two`` launched by search_for_initialization and by
   search_for_triangulation. Prints the bootstrap frame, the number of
   two-view landmarks, whether H or F won, ms per frame and the stage
   times of the bootstrap frame. The pass keeps the newest inputs of
   every (calling function, shape) it gave either kernel. After phase 17,
   both kernels were launched over this pass and the bench's mono figure
   (build and re-tracking passes: this pass alone seldom reaches the
   duplicate merge, distance_matrix), and the newest problem of every
   (calling function, shape) of the two, the local-map search
   at [4096,2000] among them, and the epipolar mask of the run's keyframes
   1 and 0 at [2000,2000] join phase 3: bit-exact against the plain
   version and the baseline kernel, and timed like the others. Last, the
   initializer runs on the card and on the CPU from the same matches and
   8-point sets (cuSOLVER against LAPACK): both succeed or both fail, and
   where they succeed the good points, rotation and translation direction
   agree.
12. Loop closing in maps of more than 64 keyframe slots: phase 7's
   controlled loop at MapConfig(96, 1000, 10000, 8) (the bounded edge
   list, the CG global BA) and at MapConfig(300, 1000, 10000, 8) (also the
   CG pose graph), with phase 7's gates; and at 300 once more with
   fix_scale=False on a monocular map whose keyframes 8-13 also drift in
   scale (2% a keyframe, up to 1.12), the lap revisited from 15 cm aside:
   there the corrected keyframes' scale returns to within 5% of 1 and the
   position error falls below 0.5 of its value (the JAX package on the
   same frames on the CPU: 0.450). Prints the stage times of the firing
   step, its edge count and its launches. (Phase 7's second run of the
   firing step from the same input is not repeated here: at 300 slots it
   takes 6-9 s, which pays for phase 18.)

13. The System façade and the host-driven Tracker:
   a. System(cfg, Sensor.RGBD) at the bench configuration with the
      default pipelining (pipeline_depth 8, fetch_batch 4): the 60-frame
      orbit, phase 6's 3 black frames, frames 2-4 again, then frames 5-7
      in localization mode. Initialized; every orbit frame returns a pose;
      the chained trajectory's median error < 0.02 m and 1 degree; no
      black frame is logged and the tracker is LOST by the second frame
      after them; the first revisit frame processed while LOST
      relocalizes within 0.05 m; localization mode leaves the keyframe
      count unchanged; the TUM, keyframe TUM and KITTI files have one line
      per logged frame, per keyframe, and 12 numbers a line; a session
      saved and loaded into a fresh System tracks the next frame. Prints
      ms per frame (insert and other calls), the relocalization frame's
      ms, device syncs per frame (torch.cuda's sync debug mode plus the
      readback waits) and K1 launches per frame.
   b. tests/test_loop_host.py's controlled loop at full width (640x480,
      1000 features, MapConfig(20, 1000, 10000, 8), min_gap=1, the
      14-frame lap plus 4, drift on keyframes 8-13) through keyframe_step,
      KeyFrameDatabase.add and LoopCloser.process: a loop fires at a
      keyframe >= 10, the aligned keyframe ATE falls below 0.35 of the
      drifted one, >= 30 landmarks welded across the loop, the mean chi2
      drops, the map stays finite. Prints the firing process()'s stage
      times; then one chunked GBA completes in ceil(10/2) polls and a
      second start mid-run bumps the generation.
   c. tests/test_lifecycle.py's tiny-capacity run at 640x480 (800
      features, MapConfig(12, 800, 2500, 8), the 60-frame orbit): the map
      grew or compacted, every frame tracked, ATE < 0.05 m, every rel_log
      row resolves through the uid archive.
   d. undistort_points on the card against the CPU (TUM1's distortion)
      within 1e-3 px.
   (System stereo and mono run through the drivers, phases 14d and 14f.)
14. The real-sequence path, at the fixtures' full width (640x480, 1000
   features; mono doubles them):
   a. the port's fixture writer (dataio/fixtures.py) writes tum_fixture
      (60 frames), kitti_fixture (30) and euroc_fixture (30, radtan
      distorted) into a temporary directory, rendering on the card;
      every PNG decodes through png.read_png to the array written. The native frame loader is built where g++ and libpng's
      header exist (then its frames must equal the plain reader's), and
      the line says so where they do not. Prints the write, decode and
      reader ms per frame, and the plain decode of a Paeth-filtered
      640x480 RGB frame.
   b-f. the drivers' main(argv), each in a working directory of its own:
      rgbd_tum --auto (the AutoTracker through prefetch() and sync()),
      rgbd_tum, stereo_kitti, stereo_euroc (rectified online on the card)
      and mono_tum in System mode. Each trajectory file is read back: one
      line per tracked frame (per keyframe for mono's
      KeyFrameTrajectory.txt) with its timestamp; ATE and RPE (delta 1)
      against the fixture's ground truth. Gated on the JAX drivers'
      outcome on the same fixtures on the CPU (DRIVER_REF,
      scripts/jax_reference_runs.py drivers): at least its share of frames
      tracked less 0.1, at most twice its ATE, the mono bootstrap at most
      2 frames after its. Prints frames tracked, keyframes, ATE, RPE, ms
      per frame, K1 launches per frame and the reader's ms per frame.
15. The multi-device paths, the viewer and the AR driver, dense BoW:
   a. MultiSeqTracker at the bench configuration (loop closing off) on
      cuda:0, B = 2 worlds (SyntheticWorld seeds 0 and 1) over the orbit's
      first 20 frames, in a world of one: per sequence initialized, never
      lost, every frame valid, median translation error < 0.02 m; sequence
      0 against a solo AutoTracker on its frames (the same valid flags and
      keyframes, poses within 1e-4: index_add_ sums in no fixed order on
      the card). Prints ms per B-frame step and per sequence-frame and K1
      launches per sequence-frame.
   b. a torch.distributed group of one rank through NCCL:
      dist_ba.ba_solve_sharded (8 poses x 4096 landmarks, 8 steps) and
      dist_pose_graph.optimize_pose_graph_sharded (a 64-vertex ring, 20
      steps) against the single-device solvers on the same fixed schedule
      (accept_all) within 1e-4; LoopCloser.poll_gba through the group on
      15a's map to its end, against the same schedule on one device within
      1e-4; the group destroyed; then the launcher
      (parallel/launch.py --nprocs 1 --device cuda) prints DISTRIBUTED OK.
   c. System(use_viewer=True) over 10 bench frames: /, /state.json and
      /frame.png over HTTP, the PNG decoded by the port's codec equal to
      draw_frame of the frame, the localization control; then the mono_ar
      driver's synthetic mode over its 80 frames: a plane found, an
      overlay PNG per tracked frame with the cube drawn.
   d. dense bow_vectors and score_l1 on the card against the CPU, exact.
16. Localization, batched dispatch, the street circuit and the
   evaluations:
   a. phase 6's tracker (the orbit mapped) saved with save_auto_state and
      loaded into AutoTracker(AutoTrackerConfig(localization_only=True)),
      which re-tracks the 60 orbit frames: the keyframe count unchanged,
      no insert, every frame valid, median error < 0.02 m and 1 degree;
      then phase 6's 3 black frames and frames 2-4: the black frames
      invalid, the first revisit frame relocalized (stats column 6 == 2)
      within 0.05 m, no reset, the keyframe count unchanged. Prints ms
      and K1 launches per frame.
   b. batch_frames=4 against batch_frames=1 (loop closing off) over 10
      orbit frames, two batches then drain() of two: trajectories,
      statistics, valid flags and keyframes equal bit for bit.
   c. the street circuit (dataio/fixtures.py make_kitti_street, rendered
      on the card: 300 stereo pairs at the KITTI 00-02 camera, 1241x376,
      a 65 m lap and 8% more, 22 cm a frame) through examples.eval_street:
      stereo_kitti --auto --kmax 40 (2000 features) at the JAX package's
      schedule, one maintenance phase a tracked frame
      (AutoTrackerConfig(whole_cycle=False)): the circuit inserts about 45
      keyframes and culls none, so the map fills up before the lap ends.
      (At the whole cycle that the --auto drivers run it inserts a
      keyframe every other frame and fills its 40 slots by frame 81.) As many frames tracked as the
      JAX package's run (STREET_REF), every keyframe slot used, as many keyframe compactions
      as the JAX run (none: an insert needs a live slot below the
      capacity, and no keyframe is culled), ATE at most twice the JAX
      run's, both kernels launched. Prints ms per frame, the reader's wait, K1 launches per
      frame, keyframes (live ones too), compactions, loops closed, the ms
      of each firing loop step and of each compaction, ATE, drift and path
      length.
   d. examples.eval_vocab on the card against scripts/eval_vocab.py's run
      on the CPU (VOCAB_REF): the same table cells (medians, separation,
      recall) and each of the 96 scores within 5e-3 (a score moves when one
      of its 600 features lands on another word: on the CPU 6 of them
      differ by more than 1e-6, the most by 1.8e-3). Prints how many are
      within 1e-6.
   e. examples.run_fixture_eval --skip-run over phase 14's run
      directories: its ATE and RPE equal phase 14's scores within 1e-6
      and its ATE cells read the same.
17. The port's bench (orb_slam2_with_comment_tpu_torch/bench.py, the
   counterpart of the repository's bench.py) at bench.py's full
   configuration: RGB-D 60 frames built then re-tracked 3 times, a
   from-scratch map-building pass, stereo and the KITTI camera and mono
   each built then re-tracked twice, timed with CUDA events, driven a
   figure at a time through the bench's own functions (figures, track,
   report). Its JSON line is logged; it must have no error and every
   figure. Every timed frame of every figure is valid (and each timed
   pass within the bench's pose gates); each timed pass launches K3 at
   least twice a tracked frame; every stereo frame, build and re-tracking
   passes, is one ``masked_best_two`` launch of the stereo association;
   on each figure's timed frames K1 launches, each K2 kernel once a view,
   K5 once a stereo frame and never elsewhere, and K4 on every figure but
   the KITTI camera's (run_bench). The mono figure's problems join phase
   11's (above).
   Every stereo path refined each pair it extracted on the card with one
   K5 launch (check_k5_per_pair), and every dense BA solve on the card
   was one ba_solve launch; the paths that keep a map (4, 6, 9, 11, 13a,
   16c, 17) ran solves (check_k4_per_solve).
   Every (calling function, shape) phases 4, 9-10, 13a, 13c and 14-16 gave
   the kernels (the local-map window at [min(4096, l_max), n_feat] before
   and after growth among them) is then held bit-exact against the plain
   version and the baseline kernel and timed; every (calling function, B,
   N) they gave K3 (the batched B = 3 solve of track_frame_core,
   track_local_map, track_reference_keyframe, the relocalization) is held
   to hold_pose's gates and timed; every (calling function, Q, N) they
   gave K7, the match tail after K1 (matching/core.match_tail), is held in
   bits against its plain version on the card and on the CPU and timed
   (per call, on the device in a replayed graph, and the plain version per
   call on the card: the eager chain it replaced), and K7's launches per
   frame are printed by phase. The kernels line's launches are phase
   16c's (a variant's row: phase 18's); launches_by_phase and launches_per_frame_by_phase list every
   path's. Every path must have launched each K2 kernel once per view it
   extracted on the card (check_k2_per_view: 3 per view, 6 per stereo
   frame). The last log line before it gives the whole run's time.
18. The configurations beyond the kernels' first variants, through the
   entry points a user calls (run_beyond): (a) the bench's RGB-D
   configuration with MapConfig(d_max=48) over 30 orbit frames, phase 4's
   tracking gates, every dense BA solve in K4's wide variant; (b) the
   KITTI-camera pair through OrbExtractor(n_features=2000, n_levels=24,
   cell=30).stereo on the card and on the CPU: the left features to phase
   3's K2 gates, right u and depth the same bits on all but 1% of the
   keypoints with a depth; (c) OrbExtractor(n_features=140000) on the
   2560x1440 frame, optimize_pose at [1,65536] and [1,131072],
   masked_best_two at [4,4194321]. Every variant of every kernel must
   have launched; a variant's row of the kernels line counts phase 18's
   launches.

    python3 chip_smoke.py --kernels-only

stops after phase 3 (a short run for work on the kernels; it prints no
``ok`` line).

The second-to-last line is a JSON object describing each kernel; the last
line is the JSON ``ok`` record.
"""
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import importlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
import warnings
import zlib

import numpy as np
import torch
import torch.distributed as dist

from orb_slam2_with_comment_tpu_torch import Sensor, System, bench, checkpoint
from orb_slam2_with_comment_tpu_torch.dataio import (
    datasets, fixtures, native_loader, png, synthetic)
from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
    POSE_CASES, SyntheticWorld, orbit_trajectory, pose_problem)
from orb_slam2_with_comment_tpu_torch.evaluation import rpe
from orb_slam2_with_comment_tpu_torch.evaluation.ate import (
    ate_rmse, camera_centers)
from orb_slam2_with_comment_tpu_torch.evaluation.trajectory import (
    read_kitti_full, read_tum_full)
from orb_slam2_with_comment_tpu_torch.examples import (
    eval_street, eval_vocab, mono_ar, run_fixture_eval)
from orb_slam2_with_comment_tpu_torch.frontend import stereo
from orb_slam2_with_comment_tpu_torch.frontend.extractor import OrbExtractor
from orb_slam2_with_comment_tpu_torch.mapstate.map import MapConfig, empty_map
from orb_slam2_with_comment_tpu_torch.matching import core as mcore
from orb_slam2_with_comment_tpu_torch.matching import search as msearch
from orb_slam2_with_comment_tpu_torch.ops import (
    cuda_lib, hamming, image, orb, orientation, sad)
from orb_slam2_with_comment_tpu_torch.optim import ba, pose_graph, pose_opt
from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams
from orb_slam2_with_comment_tpu_torch.parallel import (
    dist_ba, dist_pose_graph, launch)
from orb_slam2_with_comment_tpu_torch.parallel.multi_seq import (
    MultiSeqTracker)
from orb_slam2_with_comment_tpu_torch.models.camera import PinholeCamera
from orb_slam2_with_comment_tpu_torch.pipeline import (
    auto, auto_loop, loop_closing, steps)
from orb_slam2_with_comment_tpu_torch.pipeline.auto import (
    AutoTracker, AutoTrackerConfig)
from orb_slam2_with_comment_tpu_torch.pipeline.loop_closing import LoopCloser
from orb_slam2_with_comment_tpu_torch.pipeline.tracking import (
    Tracker, TrackerConfig, TrackState)
from orb_slam2_with_comment_tpu_torch.place import vocabulary as V
from orb_slam2_with_comment_tpu_torch.place.database import KeyFrameDatabase
from orb_slam2_with_comment_tpu_torch.solvers import initializer, pnp
from orb_slam2_with_comment_tpu_torch.visualization import draw_frame

BENCH_MAP = MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=8)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Mean ms per call of fn() inside a replayed CUDA graph of
    ``launches`` calls: the device's time, without the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps) / launches


def random_desc(gen: torch.Generator, n: int) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31, (n, 8), generator=gen,
                         dtype=torch.int64).to(torch.int32)


def planted_desc(gen: torch.Generator, q: int, n: int):
    """Query and target descriptors with planted duplicates (ties)."""
    dq, dt = random_desc(gen, q), random_desc(gen, n)
    if n > 4:
        dt[1::4] = dt[0::4][: dt[1::4].shape[0]]  # equal targets: ties
        dq[: min(q, n) // 2] = dt[: min(q, n) // 2]  # exact matches
    return dq, dt


def random_problem(gen: torch.Generator, q: int, n: int, dev):
    """A mask with ~30% admissible pairs, one all-masked row and one
    all-admissible row."""
    dq, dt = planted_desc(gen, q, n)
    mask = torch.rand((q, n), generator=gen) < 0.3
    mask[0] = False
    if q > 1:
        mask[1] = True
    return dq.to(dev), dt.to(dev), mask.to(dev)


def band_problem(gen: torch.Generator, q: int, n: int, dev):
    """A stereo-like mask: a target is admissible when its image row lies
    within 2.4 px of the query's on a 480-row image, about 1% of pairs."""
    dq, dt = planted_desc(gen, q, n)
    vq = 480.0 * torch.rand(q, generator=gen)
    vt = 480.0 * torch.rand(n, generator=gen)
    mask = (vq[:, None] - vt[None, :]).abs() <= 2.4
    return dq.to(dev), dt.to(dev), mask.to(dev)


class BaselinePose:
    """The package's first pose LM kernel (csrc/pose_lm_v1.cu), loaded
    beside the current one for the comparison and the timing only."""

    def __init__(self):
        self.lib = pose_opt.bind_solve(ctypes.CDLL(
            cuda_lib.build("pose_lm_v1")))

    def solve(self, cam, R0, t0, Xw, obs, s2, valid):
        """optimize_pose's launch, on contiguous CUDA tensors."""
        out = pose_opt.empty_result(*valid.shape, R0.device)
        err = pose_opt.launch(self.lib, cam, R0, t0, Xw, obs, s2, valid, out)
        assert err == 0, err
        return out


_BASE_POSE: list = []


def base_pose() -> BaselinePose:
    if not _BASE_POSE:
        _BASE_POSE.append(BaselinePose())
    return _BASE_POSE[0]


class BaselineOrb:
    """PR 10's orb_cells and orb_describe (csrc/orb_v1.cu), loaded beside
    the current ones for the comparison and the timing only."""

    def __init__(self):
        self.lib = orb._bind(ctypes.CDLL(cuda_lib.build("orb_v1")),
                             ORB_V1_FUNCTIONS)
        # its OrbTable: the package's up to the device level pointers
        got, want = self.lib.orb_table_bytes(), orb.V1_TABLE_BYTES
        assert got == want, (got, want)

    def cells(self, flat, levels):
        return orb.launch_cells(self.lib, flat, levels)

    def describe(self, flat, score, blurred, yx, levels):
        return orb.launch_describe(self.lib, flat, score, blurred, yx, levels)


ORB_V1_FUNCTIONS = ("orb_table_bytes", "orb_resident_blocks", "orb_cells",
                    "orb_describe")
_BASE_ORB: list = []


def base_orb() -> BaselineOrb:
    if not _BASE_ORB:
        _BASE_ORB.append(BaselineOrb())
    return _BASE_ORB[0]


class BaselineKernels:
    """The package's first Hamming kernels (csrc/hamming_v1.cu), loaded
    beside the current ones for the timing comparison only."""

    def __init__(self):
        self.lib = ctypes.CDLL(cuda_lib.build("hamming_v1"))
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.hamming_distance_matrix.argtypes = [p, p, p, i, i, p]
        self.lib.hamming_distance_matrix.restype = i
        self.lib.hamming_masked_best_two.argtypes = [p, p, p, p, p, p, p, i,
                                                     i, p]
        self.lib.hamming_masked_best_two.restype = i

    def distance_matrix(self, d1, d2):
        out = torch.empty((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                          device=d1.device)
        err = self.lib.hamming_distance_matrix(
            d1.data_ptr(), d2.data_ptr(), out.data_ptr(), d1.shape[0],
            d2.shape[0], torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out

    def masked_best_two(self, dq, dt, mask):
        q = dq.shape[0]
        outs = torch.empty((4, q), dtype=torch.int32, device=dq.device)
        err = self.lib.hamming_masked_best_two(
            dq.data_ptr(), dt.data_ptr(), mask.data_ptr(),
            *(outs.data_ptr() + 4 * q * i for i in range(4)), q,
            dt.shape[0], torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return tuple(outs.unbind(0))


def popc_per_s() -> float:
    """The card's peak popc rate: 16 results per clock on each SM
    (NVIDIA's table of arithmetic instruction throughput for compute
    capability 9.0) at the card's highest SM clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 16.0 * sms * float(mhz) * 1e6


HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def bound(n_bytes: int, n_popc: int, popc_rate: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the popcounts over the popc rate."""
    by_bytes = 1000.0 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1000.0 * n_popc / popc_rate
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bound_best_two(dq, dt, mask, popc_rate):
    """Each input read once (mask bytes, descriptors), the four [Q] outputs
    written once; 8 popc for every admissible pair of this mask."""
    q, n = mask.shape
    return bound(q * n + 32 * (q + n) + 16 * q, 8 * int(mask.sum()),
                 popc_rate)


def bound_distance_matrix(n1, n2, popc_rate):
    return bound(32 * (n1 + n2) + 4 * n1 * n2, 8 * n1 * n2, popc_rate)


def time_pair(new, old, plain, plain_reps: int = 5) -> dict:
    """Times of the kernel and the baseline kernel in turns (new, old,
    new, old; the mean of each), and the plain version's."""
    out = {"ms": 0.0, "device_ms": 0.0, "prev_ms": 0.0, "prev_device_ms": 0.0}
    for _ in range(2):
        out["ms"] += cuda_ms(new, 50) / 2
        out["prev_ms"] += cuda_ms(old, 50) / 2
        out["device_ms"] += graph_ms(new) / 2
        out["prev_device_ms"] += graph_ms(old) / 2
    out["plain_ms"] = cuda_ms(plain, plain_reps)
    return out


def assert_same(name, got, want, where):
    err = 0
    for part, a, b in zip(("best", "idx", "second", "idx2"), got, want):
        e = int((a.long() - b.long()).abs().max()) if a.numel() else 0
        assert e == 0, f"{name} {part} differs at {where}: {e}"
        err = max(err, e)
    return err


def check_kernels(dev):
    """Phase 3: bit-exact comparison and timing. Returns per-kernel rows."""
    gen = torch.Generator().manual_seed(0)
    base = BaselineKernels()
    problems = [(f"random [{q},{n}]", random_problem(gen, q, n, dev))
                for q, n in ((300, 257), (1000, 1000), (8000, 1000),
                             (1024, 8000), (4096, 1000), (4096, 2000),
                             (2000, 2000), (1241, 999), (37, 1), (1, 5))]
    problems += [(f"band [{q},{n}]", band_problem(gen, q, n, dev))
                 for q, n in ((1000, 1000), (2000, 2000), (1241, 999))]
    dq, dt = (d.to(dev) for d in planted_desc(gen, 1000, 1000))
    for name, fill in (("all-false", False), ("all-true", True)):
        problems.append((f"{name} [1000,1000]", (dq, dt, torch.full(
            (1000, 1000), fill, dtype=torch.bool, device=dev))))
    # descriptors that start 4 bytes off a 16-byte boundary
    dq, dt, mask = random_problem(gen, 301, 130, dev)
    off = [torch.cat([d.new_zeros(1), d.reshape(-1)])[1:].view(-1, 8)
           for d in (dq, dt)]
    assert all(d.data_ptr() % 16 for d in off)
    problems.append(("unaligned [301,130]", (off[0], off[1], mask)))
    # the monocular initialization window of two orbit frames
    f1, f2 = mono_first_two(dev)
    init_window = (f1.desc, f2.desc, msearch.initialization_mask(f1, f2,
                                                                 f1.xy))
    assert init_window[2].shape == (2000, 2000)
    problems.append(("initialization window [2000,2000]", init_window))
    err_bt = err_dm = 0
    for where, (dq, dt, mask) in problems:
        want = hamming.masked_best_two_plain(dq, dt, mask)
        err_bt = max(err_bt, assert_same(
            "masked_best_two", hamming.masked_best_two(dq, dt, mask), want,
            where))
        assert_same("baseline masked_best_two",
                    base.masked_best_two(dq.contiguous(), dt.contiguous(),
                                         mask), want, where)
        want = hamming.distance_matrix_plain(dq, dt)
        e = int((hamming.distance_matrix(dq, dt) - want).abs().max())
        assert e == 0, f"distance_matrix differs at {where}: {e}"
        err_dm = max(err_dm, e)
        assert torch.equal(base.distance_matrix(dq.contiguous(),
                                                dt.contiguous()), want)
        log(f"kernel check {where}: bit-exact ("
            f"{float(mask.float().mean()):.4f} admissible)")
    torch.cuda.synchronize()

    popc_rate = popc_per_s()
    log(f"bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{popc_rate / 1e12:.3f} T popc/s")
    timed = []
    for where, (dq, dt, mask) in (
            ("random [8000,1000]", random_problem(gen, 8000, 1000, dev)),
            ("random [4096,1000]", random_problem(gen, 4096, 1000, dev)),
            ("random [4096,2000]", random_problem(gen, 4096, 2000, dev)),
            ("initialization window [2000,2000]", init_window),
            ("band [1000,1000]", band_problem(gen, 1000, 1000, dev)),
            ("band [2000,2000]", band_problem(gen, 2000, 2000, dev)),
            ("band [8000,1000]", band_problem(gen, 8000, 1000, dev))):
        row = time_pair(lambda: hamming.masked_best_two(dq, dt, mask),
                        lambda: base.masked_best_two(dq, dt, mask),
                        lambda: hamming.masked_best_two_plain(dq, dt, mask))
        row["bound_ms"], row["bound_by"] = bound_best_two(dq, dt, mask,
                                                          popc_rate)
        row["problem"] = where
        row["admissible"] = float(mask.float().mean())
        timed.append(row)
        log(f"masked_best_two {where}: " + fmt_times(row))
    timed_dm = []
    for n1, n2 in ((1024, 8000), (2000, 2000), (1000, 1000)):
        d1, d2 = random_desc(gen, n1).to(dev), random_desc(gen, n2).to(dev)
        row = time_pair(lambda: hamming.distance_matrix(d1, d2),
                        lambda: base.distance_matrix(d1, d2),
                        lambda: hamming.distance_matrix_plain(d1, d2))
        row["bound_ms"], row["bound_by"] = bound_distance_matrix(n1, n2,
                                                                 popc_rate)
        row["problem"] = f"[{n1},{n2}]"
        timed_dm.append(row)
        log(f"distance_matrix [{n1},{n2}]: " + fmt_times(row))
    src = "orb_slam2_with_comment_tpu_torch/csrc/hamming.cu"
    pallas = "orb_slam2_with_comment_tpu/ops/hamming_pallas.py:59"
    # prev_ms and prev_device_ms are the baseline kernel's
    base = {"name": "hamming_v1",
            "source": "orb_slam2_with_comment_tpu_torch/csrc/hamming_v1.cu"}
    # no single PyTorch call computes either function: library_ms is null
    return [
        dict(timed[0], name="hamming_masked_best_two", route="cuda",
             source=src, replaces=pallas, baseline=base, max_abs_err=err_bt,
             library_ms=None, other_problems=timed[1:]),
        dict(timed_dm[0], name="hamming_distance_matrix", route="cuda",
             source=src, replaces=pallas, baseline=base, max_abs_err=err_dm,
             library_ms=None, other_problems=timed_dm[1:]),
    ]


F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# csrc/pose_lm.cu's float32 operations, counted from its code: per edge and
# LM iteration (the linearization with H and b, 253; the trial pose's
# chi2, 42), per edge and round and once more at the end (a projection's
# chi2), and per iteration whatever N is (the 28 + 1 sums over 256 threads,
# the damping, the 6x6 LU solve and the retract)
POSE_OPS_EDGE_ITER = 295
POSE_OPS_EDGE_ROUND = 37
POSE_OPS_ITER = 29 * 256 + 500
POSE_CAM = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)  # bench.py's


def bound_of(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 rate."""
    by_bytes = 1000.0 * n_bytes / HBM_BYTES_PER_S
    by_ops = 1000.0 * n_ops / F32_OPS_PER_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bound_pose_lm(args, rounds: int = 4, iters: int = 10):
    """(bound_ms, bound_by) of one pose LM solve: each input read once
    (the broadcast observations once for all poses), each output written
    once, against the operations the schedule does on these inputs."""
    _, R0, t0, Xw, obs, s2, valid = args
    B, N = valid.shape
    n_ops = B * (rounds * iters * (POSE_OPS_EDGE_ITER * N + POSE_OPS_ITER)
                 + (rounds + 1) * POSE_OPS_EDGE_ROUND * N)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (R0, t0, Xw, obs, s2, valid))
    n_bytes += B * (36 + 12 + N + 4 + 4)  # R, t, inliers, n_inliers, chi2
    return bound_of(n_bytes, n_ops)


def hold_pose(where: str, args, plain_reps: int = 3,
              time_baseline: bool = True):
    """The pose LM kernel on ``args`` (cam, R0, t0, Xw, obs_uvr,
    inv_sigma2, valid) against optimize_pose_plain on the card: inlier
    masks and counts identical, R and t within 1e-4, chi2 within 1e-3
    relative (float32 sums in another order), two launches bit-identical;
    against the baseline kernel (csrc/pose_lm_v1.cu, up to 7680 edges)
    bit-identical where the kernel gives a pose one block, else held to
    the same gates; then the kernel (and, with ``time_baseline``, the
    baseline kernel in turns with it) timed per wrapper call (CUDA events)
    and per launch inside a replayed CUDA graph, beside the bound and the
    plain version's time over ``plain_reps`` calls. Returns (row, largest |R| or |t|
    difference)."""
    cam, *tensors = args
    tensors = [t.contiguous() for t in tensors]
    B, N = tensors[-1].shape
    want = pose_opt.optimize_pose_plain(cam, *tensors)
    got = pose_opt.optimize_pose(cam, *tensors)
    again = pose_opt.optimize_pose(cam, *tensors)
    for part, a, b in zip(want._fields, got, again):
        assert torch.equal(a, b), f"pose_lm: two launches differ in {part} " \
            f"at {where}"
    blocks = pose_opt.blocks_per_pose(N)
    outs = [("pose_lm", got)]
    if N <= 7680:
        prev = base_pose().solve(cam, *tensors)
        if blocks == 1:
            for part, a, b in zip(want._fields, got, prev):
                assert torch.equal(a, b), \
                    f"pose_lm and pose_lm_v1 differ in {part} at {where}"
        outs.append(("pose_lm_v1", prev))
    err = 0.0
    for name, out in outs:
        assert torch.equal(out.inliers, want.inliers), \
            f"{name} inliers differ at {where}"
        assert torch.equal(out.n_inliers, want.n_inliers), where
        e = max(float((out.R - want.R).abs().max()),
                float((out.t - want.t).abs().max())) if out.R.numel() else 0.0
        assert e <= 1e-4, f"{name} pose differs at {where}: {e}"
        assert torch.allclose(out.chi2, want.chi2, rtol=1e-3, atol=1e-6), \
            f"{name} chi2 differs at {where}: {out.chi2} {want.chi2}"
        if name == "pose_lm":
            err = e
    row = {"problem": where, "B": B, "N": N, "blocks_per_pose": blocks,
           "n_valid": int(tensors[-1].sum()),
           "n_inliers": got.n_inliers.tolist(), "max_abs_err": err}

    def new():
        pose_opt.optimize_pose(cam, *tensors)

    def old():
        base_pose().solve(cam, *tensors)
    if N <= 7680 and time_baseline:
        row.update(time_pair(new, old, lambda: pose_opt.optimize_pose_plain(
            cam, *tensors), plain_reps))
    else:
        row["ms"], row["device_ms"] = cuda_ms(new, 20), graph_ms(new)
        row["plain_ms"] = cuda_ms(lambda: pose_opt.optimize_pose_plain(
            cam, *tensors), plain_reps)
    row["bound_ms"], row["bound_by"] = bound_pose_lm((cam, *tensors))
    prev = "" if N > 7680 else "; the baseline kernel " + (
        "bit-identical" if blocks == 1 else "within the gates")
    if "prev_ms" in row:
        prev += (f", {row['prev_ms']:.4f} ms per call, "
                 f"{row['prev_device_ms']:.4f} on the device")
    log(f"pose_lm {where} [{B},{N}] ({row['n_valid']} valid, inliers "
        f"{row['n_inliers']}, {blocks} block(s) a pose): same as plain (max "
        f"|dR|,|dt| {err:.2e}), bit-identical twice; kernel "
        f"{row['ms']:.4f} ms per call, {row['device_ms']:.4f} ms on the "
        f"device{prev}; plain {row['plain_ms']:.4f}; bound "
        f"{row['bound_ms']:.6f} ms by {row['bound_by']}")
    return row, err


def check_pose_kernel(dev) -> dict:
    """Phase 3, K3: the pose LM kernel held against its plain version and
    timed (hold_pose) on random problems at the main path's shapes, at
    [3x100] (one block a pose: the baseline kernel's bits), at [3x896] and
    [3x897] (7 and 8 blocks a pose on the same work), and on every case of
    tests/test_torch_pose_lm.py. Returns the kernel's row."""
    problems = [(f"random {b}x{n}", pose_problem("outliers", 300 + i, b, n))
                for i, (b, n) in enumerate(((3, 1000), (1, 1000), (3, 2000),
                                            (1, 2000), (1, 4096), (3, 4096),
                                            (1, 16384), (3, 100), (3, 896),
                                            (3, 897)))]
    problems += [(f"case {c}", pose_problem(c, 400 + i))
                 for i, c in enumerate(POSE_CASES)]
    timed, err = [], 0.0
    for where, p in problems:
        args = (POSE_CAM, *(torch.as_tensor(p[k]).to(dev) for k in (
            "R0", "t0", "Xw", "obs_uvr", "inv_sigma2", "valid")))
        row, e = hold_pose(where, args)
        timed.append(row)
        err = max(err, e)
    return dict(timed[0], name="pose_lm", route="cuda",
                source="orb_slam2_with_comment_tpu_torch/csrc/pose_lm.cu",
                baseline={"name": "pose_lm_v1", "source": "orb_slam2_with_"
                          "comment_tpu_torch/csrc/pose_lm_v1.cu"},
                replaces="orb_slam2_with_comment_tpu/optim/pose_opt.py:82 "
                         "(an XLA program, :82-176; not a Pallas kernel)",
                max_abs_err=err, library_ms=None,
                other_problems=timed[1:])


# csrc/orb.cu's float32 operations, counted from its code (multiplies,
# adds, subtractions, negations, minima, maxima, comparisons, roundings;
# the integer keys of the top-8 and of the sort count nothing): orb_cells
# per masked-in pixel (the FAST score: 2 x 57 minima and maxima of the
# arcs, 2 subtractions, the larger side, the clamp; PR 10's kernel did 192:
# 16 differences, 16 negations, 2 x 79 minima and maxima, 2 more) and per
# level pixel (8 NMS
# maxima and its comparison, the cell maximum, the threshold's comparison;
# the two blur passes, 7 multiplies and 7 adds each, and the rounding);
# orb_select per key (the rank times 1e7, the subtraction, the + 0) and per
# slot (valid's comparison); orb_describe per IC circle term (two
# multiplies, two adds), per BRIEF pattern point (two multiplies, an add or
# subtraction and a rounding for each of its row and column), and per slot
# (atan2f, sinf and cosf at about 20 each, the parabola 22, the position 4,
# the 256 comparisons)
ORB_OPS_SCORED = 120
# the minimum and maximum instructions orb_cells issues (three-input DPX
# ones on a tile of nonnegative pixels): per scored pixel the arcs' 2 x 40,
# the larger side and the clamp; per level pixel the NMS's 5, its
# comparison and the cell's maximum
ORB_MINMAX_SCORED = 2 * 40 + 2
ORB_MINMAX_PIXEL = 5 + 2
ORB_OPS_PIXEL = 11 + 29
ORB_OPS_KEY = 3
ORB_OPS_SLOT_SELECT = 1
ORB_OPS_TERM = 4
ORB_OPS_POINT = 8
ORB_OPS_SLOT_DESCRIBE = 60 + 22 + 4 + 256
ORB_CIRCLE = int(sum(2 * orientation.UMAX[abs(v)] + 1
                     for v in range(-orientation.HALF_PATCH,
                                    orientation.HALF_PATCH + 1)))


def bound_orb(kernel: str, levels, margin: int = 16,
              per_cell: int = orb.PER_CELL):
    """(bound_ms, bound_by) of one launch of an ORB kernel on ``levels``
    with ``per_cell`` candidates a cell: each input read once and each
    output written once (orb_describe's reads are the patches its slots
    need, at most each buffer once), against the float32 operations of
    csrc/orb.cu at 67 TFLOP/s."""
    px = sum(lv.h * lv.w for lv in levels)
    lo = max(3, margin)
    scored = sum(max(lv.h - 2 * lo, 0) * max(lv.w - 2 * lo, 0)
                 for lv in levels)
    cells, slots = orb.n_cells(levels), orb.n_slots(levels)
    cand = 4 * 2 * per_cell * cells  # the candidates' values and indices
    if kernel == "orb_cells":
        return bound_of(3 * 4 * px + cand,
                        ORB_OPS_SCORED * scored + ORB_OPS_PIXEL * px)
    if kernel == "orb_select":
        return bound_of(cand + 13 * slots,
                        ORB_OPS_KEY * per_cell * cells
                        + ORB_OPS_SLOT_SELECT * slots)
    return bound_of(min(4 * ORB_CIRCLE * slots, 4 * px)
                    + min(4 * 512 * slots, 4 * px) + min(20 * slots, 4 * px)
                    + (8 + 48) * slots,
                    slots * (ORB_OPS_TERM * ORB_CIRCLE + ORB_OPS_POINT * 512
                             + ORB_OPS_SLOT_DESCRIBE))


def issue_orb_cells(levels, margin: int = 16) -> float:
    """An estimate of the ms that orb_cells' minima and maxima take to
    issue at the card's highest SM clock, at an assumed 64 a clock on each
    SM: the rate of NVIDIA's table of arithmetic instruction throughput for
    compute capability 9.0, 32-bit minimum and maximum. The table lists no
    rate for the DPX instructions the kernel issues, so this is logged
    beside the times, not reported as a bound."""
    px = sum(lv.h * lv.w for lv in levels)
    lo = max(3, margin)
    scored = sum(max(lv.h - 2 * lo, 0) * max(lv.w - 2 * lo, 0)
                 for lv in levels)
    n = ORB_MINMAX_SCORED * scored + ORB_MINMAX_PIXEL * px
    return 1000.0 * n / (popc_per_s() * 64.0 / 16.0)


# the K2 problems phase 3 times: the main path's three shapes and 2560x1440
ORB_TIMED = ("orbit frame 0, 640x480, 1000", "orbit frame 1, 640x480, 2000",
             "KITTI camera, 1241x376, 2000", "2560x1440, 1000")


def orb_cases(dev):
    """Phase 3's K2 problems: (name, level images on the card, extractor,
    whether it is a rendered frame)."""
    f0, f1 = (f[0] for f in first_frames("orbit60", 2))
    kitti = first_frames("kitti30_left", 1)[0]
    R, t = orbit_trajectory(n_frames=60)[7]
    odd, _ = SyntheticWorld(seed=1).render(R, t, fx=500.0, fy=500.0,
                                           cx=320.5, cy=239.5, width=641,
                                           height=479)
    odd = np.clip(odd, 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:480, :640]
    checker = (((yy // 16) + (xx // 16)) % 2 * 180 + 40).astype(np.uint8)
    flat = np.full((480, 640), 128, np.uint8)
    big = []
    for w, h in ((1921, 1081), (2560, 1440)):
        f = 500.0 * w / 640.0
        big.append(render_job((0.0, [orbit_trajectory(n_frames=60)[7]],
                               dict(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w,
                                    height=h), "image"), dev)[0])
    cases = [("orbit frame 0, 640x480, 1000", f0, 1000, True),
             ("orbit frame 1, 640x480, 2000", f1, 2000, True),
             ("KITTI camera, 1241x376, 2000", kitti, 2000, True),
             ("odd size, 641x479, 1000", odd, 1000, True),
             ("flat, 640x480, 1000", flat, 1000, False),
             ("checkerboard, 640x480, 1000", checker, 1000, False),
             ("orbit frame 0, 640x480, 50", f0, 50, True),
             ("orbit frame 0, 640x480, 5 (levels of budget 0)", f0, 5, True),
             ("above the former 2048-cell limit, 1921x1081, 1000", big[0],
              1000, True),
             ("2560x1440, 1000", big[1], 1000, True)]
    out = []
    for name, img, n, rendered in cases:
        ext = OrbExtractor(n_features=n)
        out.append((name, ext._pyramid(torch.as_tensor(img, device=dev)),
                    ext, rendered))
    # pixels below 0 (and -0): orb_cells scores such tiles on the floats
    name, pyr, ext, _ = out[0]
    shifted = [p - 128.0 for p in pyr]
    shifted[0][::7, ::5] = -0.0
    out.append(("orbit frame 0 less 128, 640x480, 1000 (negative pixels)",
                shifted, ext, False))
    return out


def hold_describe(kernel, got_d, want_d, valid, kept, rendered, name):
    """orb_describe's gates against the plain version: xy and octave
    identical, level-0 angles identical, coarser angles within 1e-4 where
    the moments keep >= 1e-3 of their terms (``kept``), no descriptor row
    differing at an equal angle, and on a rendered frame at most 1% of
    the valid rows differing, by at most 8 bits. Returns (the largest
    held angle difference, |angle differences|, differing rows, their
    bits, differing valid rows)."""
    for part, a, b in zip(("xy", "octave"), got_d[:2], want_d[:2]):
        assert torch.equal(a, b), f"{kernel} {part} differs at {name}"
    lvl0 = want_d[1] == 0
    dang = (got_d[2] - want_d[2]).abs()
    assert torch.equal(got_d[2][lvl0], want_d[2][lvl0]), \
        f"{kernel} level-0 angles differ at {name}"
    err_ang = float(dang[kept].max()) if kept.any() else 0.0
    assert err_ang <= 1e-4, f"{kernel} angles differ at {name}: {err_ang}"
    rows = (got_d[3] != want_d[3]).any(1)
    assert not rows[dang == 0].any(), \
        f"{kernel} descriptors differ at an equal angle at {name}"
    bits = hamming.popcount32(got_d[3] ^ want_d[3]).sum(1)
    n_rows = int((rows & valid).sum())
    if rendered:
        assert n_rows <= 0.01 * int(valid.sum()), \
            f"{kernel}: {n_rows} valid descriptor rows differ at {name}"
        worst = int(bits[valid].max()) if valid.any() else 0
        assert worst <= 8, \
            f"{kernel}: a valid descriptor row differs by {worst} bits at " \
            f"{name}"
    return err_ang, dang, rows, bits, n_rows


def hold_orb(name, pyr, ext, rendered):
    """K2a, K2b and K2c each against its plain version on the same inputs,
    the baseline kernels (csrc/orb_v1.cu) too, then the chain against the
    plain chain, then two launches. Returns (max |angle| difference on
    coarser levels where the moments do not cancel, differing valid
    descriptor rows)."""
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales))
    flat = orb.pack(pyr)
    want = orb.cells_plain(flat, levels)
    got = orb.cells(flat, levels)
    prev = base_orb().cells(flat, levels)
    for kernel, out in (("orb_cells", got), ("orb_cells (orb_v1)", prev)):
        for part, a, b in zip(("score", "blurred"), out[:2], want[:2]):
            for lv in levels:
                assert torch.equal(orb._view(a, lv), orb._view(b, lv)), \
                    f"{kernel} {part} differs at {name}, level {lv.lvl}"
        assert torch.equal(out[2], want[2]), f"{kernel} values at {name}"
        assert torch.equal(out[3], want[3]), f"{kernel} indices at {name}"
    for part, a, b in zip(("score", "blurred", "values", "indices"),
                          got, prev):
        views = ([(orb._view(a, lv), orb._view(b, lv)) for lv in levels]
                 if part in ("score", "blurred") else [(a, b)])
        for x, y in views:  # bits: a zero's sign too
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), \
                f"orb_cells and orb_v1 differ in the bits of {part} at {name}"
    score, blurred, cand_v, cand_i = want
    want_s = orb.select_plain(cand_v, cand_i, levels)
    for part, a, b in zip(("yx", "response", "valid"),
                          orb.select(cand_v, cand_i, levels), want_s):
        assert torch.equal(a, b), f"orb_select {part} differs at {name}"
    yx = want_s[0]
    want_d = orb.describe_plain(flat, score, blurred, yx, levels)
    valid = want_s[2]
    kept = orb.moment_cancellation(flat, yx, levels) >= 1e-3
    err_ang, dang, rows, bits, n_rows = hold_describe(
        "orb_describe", orb.describe(flat, score, blurred, yx, levels),
        want_d, valid, kept, rendered, name)
    err_v1, _, rows_v1, _, n_rows_v1 = hold_describe(
        "orb_describe (orb_v1)", base_orb().describe(flat, score, blurred,
                                                     yx, levels),
        want_d, valid, kept, rendered, name)
    chain = orb.extract_levels(pyr, ext.budgets, ext.scales)
    again = orb.extract_levels(pyr, ext.budgets, ext.scales)
    plain = orb.extract_levels_plain(flat, levels)
    for part, a, b, c in zip(("xy", "response", "octave", "angle", "desc",
                              "valid"), chain, again, plain):
        assert torch.equal(a, b), f"two ORB launches differ in {part} at " \
            f"{name}"
        if part in ("xy", "response", "octave", "valid"):
            assert torch.equal(a, c), f"the ORB chain's {part} differs at " \
                f"{name}"
    log(f"K2 {name}: levels {[lv.budget for lv in levels]}, "
        f"{int(valid.sum())}/{len(valid)} valid; scores, blur, candidates, "
        f"yx, response, valid, octave, xy identical, level-0 angles "
        f"identical, coarser angles within {err_ang:.3g} where the moments "
        f"keep >= 1e-3 of their terms ({int((~kept).sum())} slots cancel "
        f"more: up to {float(dang[~kept].max()) if (~kept).any() else 0:.3g}"
        f" rad); descriptor rows differing {int(rows.sum())} ({n_rows} "
        f"valid, at most {int(bits.max()) if len(bits) else 0} bits); two "
        f"launches identical; orb_v1: the same cells bit for bit, angles "
        f"within {err_v1:.3g}, "
        f"descriptor rows differing {int(rows_v1.sum())} ({n_rows_v1} "
        f"valid)")
    return err_ang, n_rows


def check_orb_kernels(dev) -> list:
    """Phase 3, K2: each ORB kernel held against its plain version on
    every case of orb_cases (hold_orb), then timed at the main path's three
    shapes per wrapper call (CUDA events) and per launch in a replayed CUDA
    graph, beside its bound and the plain version's time; orb_cells'
    log line also gives issue_orb_cells' estimate. Returns the three
    kernels' rows."""
    cases = orb_cases(dev)
    err, n_rows = 0.0, 0
    for case in cases:
        e, r = hold_orb(*case)
        err, n_rows = max(err, e), n_rows + r
    torch.cuda.synchronize()
    timed = {k: [] for k in orb.LAUNCHES}
    for name, pyr, ext, _ in (c for c in cases if c[0] in ORB_TIMED):
        levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                                 tuple(ext.budgets), tuple(ext.scales))
        flat = orb.pack(pyr)
        score, blurred, cand_v, cand_i = orb.cells_plain(flat, levels)
        yx = orb.select_plain(cand_v, cand_i, levels)[0]
        runs = {
            "orb_cells": (lambda: orb.cells(flat, levels),
                          lambda: orb.cells_plain(flat, levels)),
            "orb_select": (lambda: orb.select(cand_v, cand_i, levels),
                           lambda: orb.select_plain(cand_v, cand_i, levels)),
            "orb_describe": (
                lambda: orb.describe(flat, score, blurred, yx, levels),
                lambda: orb.describe_plain(flat, score, blurred, yx,
                                           levels))}
        # the kernel and its baseline timed through one path,
        # launch_cells / launch_describe, each given its own library
        both = {"orb_cells": lambda lib: (
                    lambda: orb.launch_cells(lib, flat, levels)),
                "orb_describe": lambda lib: (
                    lambda: orb.launch_describe(lib, flat, score, blurred,
                                                yx, levels))}
        for kernel, (fn, plain) in runs.items():
            row = {"problem": name}
            if kernel in both:
                row.update(time_pair(both[kernel](orb._kernel_lib()),
                                     both[kernel](base_orb().lib), plain, 3))
            else:
                row.update(ms=cuda_ms(fn, 50), device_ms=graph_ms(fn),
                           plain_ms=cuda_ms(plain, 3))
            row["bound_ms"], row["bound_by"] = bound_orb(kernel, levels)
            timed[kernel].append(row)
            prev = (f"; orb_v1 {row['prev_ms']:.4f} and "
                    f"{row['prev_device_ms']:.4f}" if "prev_ms" in row else "")
            # an estimate at an assumed rate, logged only
            issue = (f"; min/max issue estimate {issue_orb_cells(levels):.6f}"
                     if kernel == "orb_cells" else "")
            log(f"{kernel} {name}: kernel {row['ms']:.4f} ms per call, "
                f"{row['device_ms']:.4f} ms on the device{prev}; plain "
                f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.6f} ms by "
                f"{row['bound_by']}{issue}")
        chain = cuda_ms(lambda: orb.extract_levels(pyr, ext.budgets,
                                                   ext.scales), 50)
        chain_dev = graph_ms(lambda: orb.extract_levels(pyr, ext.budgets,
                                                        ext.scales))
        eager = cuda_ms(lambda: orb.extract_levels_plain(flat, levels), 3)
        pyramid = cuda_ms(lambda: ext._pyramid(pyr[0]), 20)
        log(f"K2 chain {name}: {chain:.4f} ms per view ({chain_dev:.4f} on "
            f"the device), the plain chain {eager:.4f}; the pyramid before "
            f"it {pyramid:.4f}")
    src = "orb_slam2_with_comment_tpu_torch/csrc/orb.cu"
    xla = ("orb_slam2_with_comment_tpu/frontend/extractor.py:118 (XLA ops, "
           ":118-203, on ops/{fast,image,orientation,brief}.py; not a "
           "Pallas kernel)")
    base = {"name": "orb_v1",
            "source": "orb_slam2_with_comment_tpu_torch/csrc/orb_v1.cu"}
    # no single PyTorch call computes any of the three: library_ms is null
    return [dict(rows[0], name=k, route="cuda", source=src, replaces=xla,
                 max_abs_err=err if k == "orb_describe" else 0.0,
                 differing_valid_descriptor_rows=(
                     n_rows if k == "orb_describe" else 0),
                 library_ms=None, other_problems=rows[1:],
                 **({"baseline": base} if k != "orb_select" else {}))
            for k, rows in timed.items()]



# ---------------------------------------------------------------------------
# phase 3, K5 (csrc/stereo_sad.cu) and K4 (csrc/ba.cu)
# ---------------------------------------------------------------------------

# csrc/stereo_sad.cu's float32 operations per keypoint, counted from its
# code: each of the 11 x 121 window elements two subtractions of a centre,
# the difference, its absolute value and the sum's add; the parabola, the
# rounding and the position about 20; the tail (the gates, the disparity,
# the median's four passes, the threshold and the division) about 20
SAD_OPS_KEY = 11 * 121 * 5 + 20 + 20
# the pixels a keypoint needs: its 11x11 window and 11x21 strip
SAD_PIXELS_KEY = 121 + 231


def bound_sad(n: int):
    """(bound_ms, bound_by) of one stereo_depth call on n keypoints: the
    pixels each keypoint needs, its xy, K1's distance and index and the
    gathered right u read once, u and depth written once, against the
    float32 operations."""
    return bound_of(n * (4 * SAD_PIXELS_KEY + 8 + 4 + 4 + 4 + 8),
                    n * SAD_OPS_KEY)


def sad_cases(dev):
    """Phase 3's K5 problems: (name, left and right views on the card,
    features, bf, fx, variant): the rendered bench pair (orbit frame 0 and
    its right view at the 8 cm baseline), the KITTI-camera pair, an odd
    size (641x479), the bench pair with 5 features (levels of budget 0),
    the bench pair with a fifth of the keypoints on the image border and
    a fifth of the coarse right u off either side ("edges"), with every
    best_d >= 75 ("unmatched"), the KITTI pair at 4096 features, and the
    bench pair with ties at the median ("ties")."""
    left = first_frames("orbit60", 1)[0][0]
    right = first_frames("orbit60_right", 1)[0]
    kl, kr = (first_frames(s, 1)[0] for s in ("kitti30_left",
                                              "kitti30_right"))
    pose = orbit_trajectory(n_frames=60)[7]
    odd = render_job((0.0, [pose] + right_view([pose], BENCH_BASELINE),
                      dict(fx=500.0, fy=500.0, cx=320.5, cy=239.5,
                           width=641, height=479), "image"), dev)
    kitti = (kl, kr, bench.KITTI_BF, bench.KITTI_CAM["fx"])
    pair = (left, right, 40.0, 500.0)
    return [("bench pair, 640x480, 1000", *pair[:2], 1000, *pair[2:],
             None),
            ("KITTI camera, 1241x376, 2000", *kitti[:2], 2000, *kitti[2:],
             None),
            ("odd size, 641x479, 1000", odd[0], odd[1], 1000, *pair[2:],
             None),
            ("bench pair, 5 (levels of budget 0)", *pair[:2], 5,
             *pair[2:], None),
            ("bench pair, 1000, window and strip at the edges", *pair[:2],
             1000, *pair[2:], "edges"),
            ("bench pair, 1000, every best_d >= 75 (median inf)",
             *pair[:2], 1000, *pair[2:], "unmatched"),
            ("KITTI camera, 1241x376, 4096", *kitti[:2], 4096, *kitti[2:],
             None),
            ("bench pair, 1000, ties at the median", *pair[:2], 1000,
             *pair[2:], "ties")]


def sad_inputs(dev, left, right, n, bf, fx, variant, **kw):
    """K5's inputs on the main path: the packed pyramids, the level table,
    the left and right keypoints, K1's best distance and index of the
    stereo association, and the left valid flags. ``variant``: None,
    "edges", "unmatched" or "ties" (sad_cases); ``kw``: more OrbExtractor
    keywords."""
    ext = OrbExtractor(n_features=n, **kw)
    pyr = [ext._pyramid(torch.as_tensor(im, device=dev))
           for im in (left, right)]
    fl, fr = (ext._extract_from_pyramid(p) for p in pyr)
    scales = image.level_scales(len(pyr[0]))
    mask = stereo.association_mask(fl, fr, scales, float(np.float32(fx)))
    best_d, best_j, _, _ = hamming.masked_best_two(fl.desc, fr.desc, mask)
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr[0]),
                             tuple(ext.budgets), tuple(scales))
    flat_l, flat_r = orb.pack(pyr[0]), orb.pack(pyr[1])
    xy, xy_r = fl.xy.clone(), fr.xy.clone()
    if variant == "edges":
        h, w = pyr[0][0].shape
        k = n // 5
        xy[:k:2, 0] = 0.0
        xy[1:k:2, 1] = h - 1.0
        # two right keypoints off either side of the image
        m = xy_r.shape[0]
        xy_r = torch.cat([xy_r, torch.tensor([[-2.0, 0.0], [w + 10.0, 0.0]],
                                             device=dev)])
        best_j = best_j.clone()
        best_j[k:2 * k:2] = m
        best_j[k + 1:2 * k:2] = m + 1
    elif variant == "unmatched":
        best_d = torch.full_like(best_d, stereo.TH_ORB + 5)
    elif variant == "ties":
        _, d = sad.stereo_depth_plain(flat_l, flat_r, levels, xy, xy_r,
                                      best_d, best_j, bf, fx)
        best_d, best_j = best_d.clone(), best_j.clone()
        for lv in levels:
            good = torch.nonzero(d[lv.slot:lv.slot + lv.budget] > 0)[:, 0]
            if good.numel() == 0:
                continue
            src = lv.slot + int(good[0])
            to = torch.tensor([i for i in range(lv.slot, lv.slot + lv.budget)
                               if i % 3 and i != src], device=dev)
            xy[to] = xy[src].clone()
            best_d[to] = best_d[src].clone()
            best_j[to] = best_j[src].clone()
    return flat_l, flat_r, levels, xy, xy_r, best_d, best_j, fl.valid


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def sad_stamps(args, bf, fx, reps: int = 5) -> dict:
    """K5's two phases in us from its stamps (block 0 reads the card's
    globaltimer at the start, after the grid barrier that ends the
    refinement and the per-keypoint tail, and after a second barrier that
    ends the median's sweep), the mean over ``reps`` launches."""
    lay = sad.layout(args[2])
    st = torch.zeros(sad.N_STAMPS, dtype=torch.int64, device=args[0].device)
    out = {"refine_us": 0.0, "sweep_us": 0.0}
    for _ in range(reps):
        sad.launch_depth(sad._kernel_lib(), lay, *args[:2], *args[3:], bf,
                         fx, stamps=st)
        t = (st.double() / 1e3).tolist()
        out["refine_us"] += (t[1] - t[0]) / reps
        out["sweep_us"] += (t[2] - t[1]) / reps
    return out


def hold_sad(where, flat_l, flat_r, levels, xy, xy_r, best_d, best_j, valid,
             bf, fx, variant):
    """K5 against stereo_depth_plain on the same card: u_right and depth in
    bits; the best SAD, ok and the best shift in bits against
    sad_refine_plain (the SADs sum in its order); two launches in bits.
    The first design (csrc/stereo_sad_v1.cu) on the same coarse right u
    against sad_refine_plain: the best shift and ok identical except at
    near-ties (the two lowest SADs within 1e-5 relative), which stay under
    0.5% of the valid keypoints; u within 1e-4 px where both are ok at the
    same shift, the best SAD within 1e-5 relative where both pick it. Then
    both timed per call (CUDA events) and per launch in a replayed CUDA
    graph in turns (new, first design, first design, new), beside the
    bound, the plain version and the parent's path after K1 (the first
    design, then stereo_tail_plain's eager ops). Returns (row, largest |u|
    difference of the first design)."""
    args = (flat_l, flat_r, levels, xy, xy_r, best_d, best_j)
    lay = sad.layout(levels)
    n = lay.n
    got = sad.stereo_depth(*args, bf, fx)
    out = sad.launch_depth(sad._kernel_lib(), lay, flat_l, flat_r, xy, xy_r,
                           best_d, best_j, bf, fx)
    again = sad.outputs(out, n)
    assert torch.equal(_bits(got[0]), _bits(again["u_right"])) and \
        torch.equal(_bits(got[1]), _bits(again["depth"])), \
        f"stereo_depth: two launches differ at {where}"
    want = sad.stereo_depth_plain(*args, bf, fx)
    u_r0 = xy_r[best_j.long(), 0]
    ref = sad.sad_refine_plain(flat_l, flat_r, levels, xy, u_r0)
    curves = sad.sad_curves_plain(flat_l, flat_r, levels, xy, u_r0)
    for part, a, b in (("u_right", got[0], want[0]),
                       ("depth", got[1], want[1]),
                       ("best SAD", again["sad"], ref[1]),
                       ("ok", again["ok"], ref[2]),
                       ("best shift", again["best"].long(),
                        curves.argmin(1))):
        assert torch.equal(_bits(a), _bits(b)), \
            f"stereo_depth: {part} is not the plain version's bits at " \
            f"{where}: {int((_bits(a) != _bits(b)).sum())} differ"
    n_good = int((want[1] > 0).sum())
    good = again["key"] != -1
    if variant == "unmatched":
        assert n_good == 0 and int(good.sum()) == 0, where
    if variant == "ties":
        s = again["sad"][good].sort().values
        med = s[int(good.sum()) // 2]
        n_tied = int((s == med).sum())
        assert n_tied >= 2, f"no tie at the median at {where}"
    # the first design on the same coarse u
    u, s, ok, best = sad.launch(sad._v1_kernel_lib(), flat_l, flat_r,
                                levels, xy, u_r0)
    two = curves.topk(2, dim=1, largest=False).values if n else curves
    near = ((two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1].abs() if n
            else torch.zeros(0, dtype=torch.bool, device=xy.device))
    same = best.long() == curves.argmin(1)
    n_valid = int(valid.sum())
    assert bool((same | near).all()), f"stereo_sad_v1 best shift at {where}"
    assert bool(((ok == ref[2]) | near).all()), \
        f"stereo_sad_v1 ok at {where}"
    n_near = int((near & valid).sum())
    assert n_near <= 0.005 * n_valid, \
        f"stereo_sad_v1: {n_near} near-ties of {n_valid} valid at {where}"
    both = same & ok & ref[2]
    err = float((u - ref[0]).abs()[both].max()) if bool(both.any()) else 0.0
    assert err <= 1e-4, f"stereo_sad_v1 u differs at {where}: {err}"
    assert torch.allclose(s[same], ref[1][same], rtol=1e-5, atol=0), where
    v1_bits = sum(int((_bits(a) != _bits(b)).sum())
                  for a, b in zip((u, s, ok), ref))

    def new():
        sad.stereo_depth(*args, bf, fx)

    def v1():
        sad.sad_refine(flat_l, flat_r, levels, xy, u_r0)

    def parent_path():
        ur, sb, okb = sad.sad_refine(flat_l, flat_r, levels, xy,
                                     xy_r[best_j.long(), 0])
        sad.stereo_tail_plain(ur, sb, okb, best_d, xy[:, 0], bf, fx)
    turns = [(name, cuda_ms(fn, 50), graph_ms(fn))
             for name, fn in (("new", new), ("v1", v1), ("v1", v1),
                              ("new", new))]
    mean = {k: (sum(t[1] for t in turns if t[0] == k) / 2,
                sum(t[2] for t in turns if t[0] == k) / 2)
            for k in ("new", "v1")}
    row = {"problem": where, "N": n, "n_valid": n_valid,
           "n_good": n_good, "max_abs_err": 0.0,
           "grid": sad._kernel_lib().stereo_depth_grid(n) if n else 0,
           "ms": mean["new"][0], "device_ms": mean["new"][1],
           "turns": [[t[0], t[1], t[2]] for t in turns],
           "baseline": {"name": "stereo_sad_v1",
                        "source": "orb_slam2_with_comment_tpu_torch/csrc/"
                                  "stereo_sad_v1.cu",
                        "ms": mean["v1"][0], "device_ms": mean["v1"][1],
                        "near_ties": n_near, "max_abs_err": err,
                        "differing_bits": v1_bits},
           "parent_path_ms": cuda_ms(parent_path, 20),
           "plain_ms": cuda_ms(lambda: sad.stereo_depth_plain(*args, bf, fx),
                               10),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound_sad(n)
    if n:
        row.update(sad_stamps(args, bf, fx))
    log(f"stereo_depth {where} [{n} keypoints, {n_valid} valid, {n_good} "
        f"with depth, {row['grid']} blocks]: u_right, depth, SAD, ok and best shift the plain "
        f"version's bits, two launches too; kernel {row['ms']:.4f} ms per "
        f"call, {row['device_ms']:.4f} ms on the device (stamps: refinement "
        f"{row.get('refine_us', 0):.2f} us, median sweep "
        f"{row.get('sweep_us', 0):.2f} us); stereo_sad_v1 (refinement "
        f"alone, in turns) {mean['v1'][0]:.4f} / {mean['v1'][1]:.4f} "
        f"({n_near} near-ties on valid keypoints, max |du| {err:.2e}, "
        f"{v1_bits} outputs not the plain version's bits); the parent's "
        f"path after K1 {row['parent_path_ms']:.4f} ms per call; plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.6f} ms by "
        f"{row['bound_by']}; turns {row['turns']}")
    return row, err


def check_sad_kernel(dev) -> dict:
    """Phase 3, K5: the stereo match after the association held against its
    plain version and timed on every case of sad_cases. Returns the
    kernel's row."""
    timed, err = [], 0.0
    for name, left, right, n, bf, fx, variant in sad_cases(dev):
        bf, fx = sad._f32(bf), sad._f32(fx)
        ins = sad_inputs(dev, left, right, n, bf, fx, variant)
        row, e = hold_sad(name, *ins, bf, fx, variant)
        timed.append(row)
        err = max(err, e)
    return dict(timed[0], name="stereo_sad", route="cuda",
                source="orb_slam2_with_comment_tpu_torch/csrc/stereo_sad.cu",
                replaces="orb_slam2_with_comment_tpu/frontend/stereo.py:34 "
                         "(_sad_refine_block, an XLA program a level, called"
                         " at :135) and the tail at :141-161 (not a Pallas "
                         "kernel)",
                other_problems=timed[1:])


# csrc/ba.cu's operations an LM iteration, counted from PR 13's two kernels
# (csrc/ba_v1.cu; the redesign does the same arithmetic): per active
# observation (the projection and residual 20, the Huber weight 6, the
# Jacobians 60, Hll and bl 72, Y 90, Y Hll^-1 90), per landmark (the damping
# and the 3x3 inverse 50), per pair of observations of one landmark by free
# poses p <= q (a 6x6 block of 3-term sums, 216), per active observation of
# a free pose once more (Hpp, bp and the b correction, 288); the update per
# active observation of a free pose (Y^T dxi, 36), per landmark (dX and X,
# 21), per active observation (the candidate's chi2, 30), per pose (the
# retract, about 200); and the reduced system's Cholesky factorization and
# two triangular solves over n = 6 x the free poses, n^3 / 3 + 2 n^2
BA_OPS_OBS, BA_OPS_LM, BA_OPS_PAIR, BA_OPS_DIAG = 338, 50, 216, 288
BA_OPS_UPD_FREE, BA_OPS_UPD_LM, BA_OPS_UPD_OBS, BA_OPS_POSE = 36, 21, 30, 200


def ba_counts(prob) -> dict:
    """What this problem's data gives the kernel to do: active
    observations, those of free poses, the pairs (p <= q) of one
    landmark's observations by free poses, and the free poses."""
    act = (prob.obs_w > 0) & prob.point_valid[:, None]
    free = act & ~prob.pose_fixed[prob.obs_pose]
    pose = torch.where(free, prob.obs_pose, -1)
    pairs = ((pose[:, :, None] <= pose[:, None, :]) & free[:, :, None]
             & free[:, None, :]).sum()
    return {"active": int(act.sum()), "free": int(free.sum()),
            "pairs": int(pairs), "free_poses": int((~prob.pose_fixed).sum())}


def bound_ba(prob, iters: int):
    """(bound_ms, bound_by) of one ba_solve launch: the problem read once
    (12 + 4 + 8 bytes an observation slot, 12 + 1 a landmark, 48 + 1 a
    pose) and its results written once (the poses, landmarks, damping,
    chi2, per-observation chi2 and trace), against ``iters`` times an
    iteration's operations on this problem's data, the factorization's
    included, at the float32 rate (67 TFLOP/s)."""
    P, L = prob.R.shape[0], prob.X.shape[0]
    D = prob.obs_w.shape[1]
    c = ba_counts(prob)
    n = 6 * c["free_poses"]
    read = 24 * L * D + 13 * L + 49 * P
    write = 48 * P + 12 * L + 4 * L * D + 8 + 12 * iters
    per_iter = (BA_OPS_OBS * c["active"] + BA_OPS_LM * L
                + BA_OPS_PAIR * c["pairs"] + BA_OPS_DIAG * c["free"]
                + BA_OPS_UPD_FREE * c["free"] + BA_OPS_UPD_LM * L
                + BA_OPS_UPD_OBS * c["active"] + BA_OPS_POSE * P
                + n ** 3 // 3 + 2 * n ** 2)
    return bound_of(read + write, iters * per_iter)


# K4's accept test compares its two chi2 sums in float64; the JAX package
# compares float32 sums. Over every solve hold_ba holds: the solves, their
# iterations, and those where a float32 strict < of the two sums rounded to
# float32 (the trace's values) parts from the float64 comparison (the
# trace's fourth column): where the two sums round to one float32
ACCEPT_TEST = {"solves": 0, "iterations": 0, "f32_differs": 0}


def accept_f32_differs(trace: torch.Tensor, accept_all: bool) -> int:
    """The iterations of a K4 trace [iters, 4] (chi2_old, chi2_new as
    float32, accepted, chi2_new < chi2_old in float64) whose float32 and
    float64 comparisons of the two chi2s part."""
    if accept_all or not len(trace):
        return 0
    f32 = (trace[:, 1] < trace[:, 0]).float()
    return int((f32 != trace[:, 3]).sum())


def tally_accept_test(trace: torch.Tensor, accept_all: bool) -> int:
    n = accept_f32_differs(trace, accept_all)
    ACCEPT_TEST["solves"] += 1
    ACCEPT_TEST["iterations"] += 0 if accept_all else len(trace)
    ACCEPT_TEST["f32_differs"] += n
    return n


def damping_after(accepted, lam, accept_all: bool) -> float:
    """The damping an accept sequence leads to, as the kernel computes it."""
    lam = np.float32(lam)
    for ok in ([] if accept_all else accepted):
        lam = np.float32(lam * np.float32(0.5 if ok else 5.0))
        lam = min(max(lam, np.float32(1e-9)), np.float32(1e8))
    return float(lam)


class BaselineBa:
    """PR 13's K4 (csrc/ba_v1.cu: ba_assemble and ba_update, two cooperative
    launches an LM iteration around torch.linalg.solve_ex), loaded beside
    the current kernel for the timing only."""

    class Args(ctypes.Structure):
        """csrc/ba_v1.cu's BaArgs, field for field."""
        _fields_ = [(n, ctypes.c_void_p) for n in (
            "obs_uvr", "obs_w", "obs_pose", "pose_fixed", "point_valid",
            "order", "starts", "R", "t", "X", "lam", "rec", "hinv", "bl",
            "mask", "partial", "chi2_old", "S", "b", "sol", "Rn", "tn", "Xn",
            "trace", "obs_chi2", "chi2")] + [
            (n, ctypes.c_int) for n in ("P", "L", "D")] + [
            (n, ctypes.c_float) for n in ("fx", "fy", "cx", "cy", "bf",
                                          "huber_mono", "huber_stereo")] + [
            (n, ctypes.c_int) for n in ("robust", "iter", "mode")]

    def __init__(self):
        self.lib = ctypes.CDLL(cuda_lib.build("ba_v1"))
        for name in ("ba_args_bytes", "ba_max_grid", "ba_record_floats"):
            getattr(self.lib, name).argtypes = []
            getattr(self.lib, name).restype = ctypes.c_int
        for name in ("ba_assemble", "ba_update"):
            getattr(self.lib, name).argtypes = [ctypes.c_void_p] * 2
            getattr(self.lib, name).restype = ctypes.c_int
        assert self.lib.ba_args_bytes() == ctypes.sizeof(self.Args)

    def solve(self, cam, prob, iters, robust=True, init_lambda=1e-4,
              accept_all=False):
        """PR 13's ba_solve on CUDA tensors: per solve a stable sort of the
        free poses' observations by pose; per iteration ba_assemble,
        torch.linalg.solve_ex, ba_update."""
        dev, f32 = prob.X.device, torch.float32
        P, L = prob.R.shape[0], prob.X.shape[0]
        D = prob.obs_w.shape[1]
        prob = ba.BAProblem(*(x.contiguous() for x in prob))
        act = ((prob.obs_w > 0) & prob.point_valid[:, None]
               & ~prob.pose_fixed[prob.obs_pose])
        keys, order = torch.sort(torch.where(act, prob.obs_pose, P)
                                 .reshape(-1), stable=True)
        keep = {"order": order.to(torch.int32),
                "starts": torch.searchsorted(keys, torch.arange(
                    P + 1, device=dev)).to(torch.int32),
                "R": prob.R.clone(), "t": prob.t.clone(), "X": prob.X.clone(),
                "lam": ba._init_lambda(init_lambda, prob.X).reshape(1)
                .clone(), "rec": torch.empty(L * D, self.lib
                                              .ba_record_floats(), device=dev),
                "hinv": torch.empty(L, 9, device=dev),
                "bl": torch.empty(L, 3, device=dev),
                "mask": torch.empty(L, dtype=torch.int64, device=dev),
                "partial": torch.empty(3, self.lib.ba_max_grid(), device=dev),
                "chi2_old": torch.empty(1, device=dev),
                "chi2": torch.empty(1, device=dev),
                "S": torch.empty(6 * P, 6 * P, device=dev),
                "b": torch.empty(6 * P, device=dev),
                "Rn": torch.empty(P, 3, 3, device=dev),
                "tn": torch.empty(P, 3, device=dev),
                "Xn": torch.empty(L, 3, device=dev),
                "trace": torch.zeros(max(iters, 1), 3, dtype=f32, device=dev),
                "obs_chi2": torch.empty(L, D, device=dev),
                "zero": torch.zeros(6 * P, 1, device=dev)}
        a = self.Args()
        for name in ("obs_uvr", "obs_w", "obs_pose", "pose_fixed",
                     "point_valid"):
            setattr(a, name, getattr(prob, name).data_ptr())
        for name, x in keep.items():
            if name != "zero":
                setattr(a, name, x.data_ptr())
        a.P, a.L, a.D = P, L, D
        a.fx, a.fy, a.cx, a.cy, a.bf = cam
        a.huber_mono, a.huber_stereo = ba._HUBER
        a.robust = int(robust)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(name):
            assert getattr(self.lib, name)(ctypes.addressof(a), stream) == 0

        for it in range(iters):
            launch("ba_assemble")
            sol, _ = torch.linalg.solve_ex(keep["S"], keep["b"][:, None])
            keep["sol"] = sol
            a.sol, a.iter = sol.data_ptr(), it
            a.mode = (1 if accept_all else 0) | (2 if it == iters - 1 else 0)
            launch("ba_update")
        if iters == 0:
            a.sol, a.mode = keep["zero"].data_ptr(), 4 | 2
            launch("ba_update")
        return ba.BAResult(keep["R"], keep["t"], keep["X"],
                           keep["chi2"].reshape(()), keep["obs_chi2"],
                           keep["lam"].reshape(()))


_BASE_BA: list = []


def base_ba() -> BaselineBa:
    if not _BASE_BA:
        _BASE_BA.append(BaselineBa())
    return _BASE_BA[0]


# the phases of a ba_solve launch between its stamps (KernelSolve.
# record_phases): the structure once; an iteration's linearization (with the
# previous iteration's accept test), Schur sums, the system's sums (block 0),
# factorization and solve (block 0), update; the last accept test, the
# orthonormalization and the per-observation chi2
BA_PHASES = ("structure", "linearize", "schur", "system", "factorize",
             "update", "finish")


def ba_phases(cam, prob, iters, robust, lam0, accept_all,
              reps: int = 5) -> dict:
    """Each phase's ms in one launch of the whole solve, from the stamps
    block 0 writes after each grid barrier (the card's globaltimer),
    the mean over ``reps`` launches, and the launch's own ms between its
    first and last stamp."""
    out = dict.fromkeys(BA_PHASES + ("launch",), 0.0)
    for _ in range(reps):
        ks = ba.KernelSolve(cam, prob, iters, robust, lam0, accept_all)
        st = ks.record_phases()
        ks.run()
        t = (st.double() / 1e6).tolist()
        out["structure"] += t[1] - t[0]
        prev = t[1]
        for it in range(iters):
            k = 2 + 5 * it
            for name, j in zip(BA_PHASES[1:6], range(5)):
                out[name] += t[k + j] - (prev if j == 0 else t[k + j - 1])
            prev = t[k + 4]
        out["finish"] += t[-1] - prev
        out["launch"] += t[-1] - t[0]
    return {k: v / reps for k, v in out.items()}


def hold_ba(where: str, args, plain_reps: int = 3, time_baseline=True):
    """K4 on ``args`` (cam, problem, iterations, robust, initial damping,
    accept_all) against ba_solve_plain on the same card: one launch a
    solve; the first reduced camera system S and b_s within 1e-5 of max
    |S|, or within twice the plain float32 system's own distance from the
    float64 one where that is larger (S sums thousands of terms and
    cancels Hpp against the Schur term: its float32 rounding grows with
    the map); the first iteration's step, the kernel's float64 solution of
    its own float64 S, within n kappa 2^-52 (relative, in the max norm) of
    torch.linalg.solve of that S in float64 (n = 6P rows, kappa its
    2-norm condition number: the forward error bound of a backward stable
    solve, which both are); the accept sequence identical wherever
    |chi2_new / chi2_old - 1| > 1e-5 (nearer to convergence the test's two
    sums are equal within their float32 rounding, and either version may
    decide either way) and R, t and X within 1e-4, where float32 resolves
    the problem: where the plain float32 solve ends within 1e-4 of a
    float64 solve of it (the monocular bootstrap's two-view map has a free
    scale, along which any two float32 solves part by about 1e-3: there
    the sequences and distances are reported); the final damping equal
    where the sequences are, else the one the kernel's own sequence leads
    to; chi2 within 1e-3 relative; two solves bit for bit. Then the solve
    timed per call (CUDA events) and per launch in a replayed CUDA graph,
    with PR 13's kernels (csrc/ba_v1.cu, per call) in turns where
    ``time_baseline``, beside the bound and ba_solve_plain; the phases'
    ms from the kernel's stamps; and the first system solved by
    torch.linalg.solve_ex in float64 (the library beside the kernel's
    factorize phase). Returns (row, largest |R|, |t|, |X| difference)."""
    cam, prob, iters, robust, lam0, accept_all = args
    p64 = prob._replace(**{f: getattr(prob, f).double() for f in (
        "R", "t", "X", "obs_uvr", "obs_w")})

    def system_dist(S1, b1, S2, b2):
        return max(float((S1.double() - S2.double()).abs().max()),
                   float((b1.double() - b2.double()).abs().max()))
    S, b_s, _ = ba.first_system_plain(cam, prob, robust, lam0)
    S_floor = system_dist(S, b_s, *ba.first_system_plain(cam, p64, robust,
                                                         lam0)[:2])
    first = ba.KernelSolve(cam, prob, iters, robust, lam0, accept_all)
    S_k, b_k = first.assemble()
    scale = float(S.abs().max())
    e_S = system_dist(S_k, b_k, S, b_s)
    assert e_S <= max(1e-5 * scale, 2 * S_floor), \
        f"ba_solve: the first S or b_s differs by {e_S} (max |S| {scale}; " \
        f"the plain float32 system is {S_floor} from float64) at {where}"
    before = ba.LAUNCHES["ba_solve"]
    got = ba.ba_solve(cam, prob, iters, robust, lam0, accept_all)
    assert ba.LAUNCHES["ba_solve"] == before + 1, where
    ks = ba.KernelSolve(cam, prob, iters, robust, lam0, accept_all)
    again = ks.run()
    for part, a, b in zip(got._fields, got, again):
        assert torch.equal(a, b), f"K4: two solves differ in {part} at {where}"
    e_step, step_tol, kappa = 0.0, 0.0, 0.0
    if iters:
        x_ref = torch.linalg.solve(first.S64, first.b64)
        kappa = float(torch.linalg.cond(first.S64))
        step_tol = first.S64.shape[0] * kappa * 2.0 ** -52
        e_step = float((ks.step0 - x_ref).abs().max()) / max(
            float(x_ref.abs().max()), 1e-300)
        assert e_step <= step_tol, \
            f"K4 first step {e_step} from float64 (relative; bound " \
            f"{step_tol}, condition {kappa}) at {where}"
    trace = []
    want = ba.ba_solve_plain(cam, prob, iters, robust, lam0, accept_all,
                             trace)

    def dist(a, b):
        return max(float((getattr(a, f).double() - getattr(b, f).double())
                         .abs().max()) for f in ("R", "t", "X"))
    exact = ba.ba_solve_plain(cam, p64, iters, robust, lam0, accept_all)
    floor = dist(want, exact)
    mine = ks.trace[:iters].cpu()
    plain = torch.stack(trace).cpu() if trace else mine
    moved = (plain[:, 1] / plain[:, 0] - 1).abs() > 1e-5
    # float32 resolves this problem: the plain float32 solve ends within
    # 1e-4 of the float64 one
    resolved = floor <= 1e-4
    if resolved:
        assert torch.equal(mine[:, 2][moved], plain[:, 2][moved]), \
            f"K4 accept sequence {mine[:, 2].tolist()} against " \
            f"{plain[:, 2].tolist()} at {where}"
    flips = int((mine[:, 2] != plain[:, 2]).sum())
    f32_differs = tally_accept_test(mine, accept_all)
    lam_f = float(torch.as_tensor(lam0))
    assert float(got.final_lambda) == damping_after(
        mine[:, 2].tolist(), lam_f, accept_all), where
    if not flips:
        assert float(got.final_lambda) == float(want.final_lambda), where
    err, err64 = dist(got, want), dist(got, exact)
    assert err <= 1e-4 or not resolved, \
        f"K4 R, t or X differs by {err} at {where}, {err64} from float64 " \
        f"(the plain float32 solve is {floor} from float64)"
    assert torch.allclose(got.chi2, want.chi2, rtol=1e-3, atol=1e-6), \
        f"K4 chi2 {float(got.chi2)} against {float(want.chi2)} at {where}"
    P, L = prob.R.shape[0], prob.X.shape[0]
    D = prob.obs_w.shape[1]
    counts = ba_counts(prob)

    def new():
        ba.ba_solve(cam, prob, iters, robust, lam0, accept_all)

    def old():
        base_ba().solve(cam, prob, iters, robust, lam0, accept_all)

    row = {"problem": where, "P": P, "L": L, "D": D, **counts,
           "iters": iters, "accept_flips": flips,
           "accept_f32_differs": f32_differs, "vs_f64": err64,
           "plain_f32_vs_f64": floor, "resolved_by_float32": resolved,
           "first_S_err": e_S, "S_scale": scale,
           "S_plain_f32_vs_f64": S_floor,
           "first_step_vs_f64": e_step, "first_step_bound": step_tol,
           "S_condition": kappa, "max_abs_err": err, "grid": ks.grid()}
    if time_baseline:
        row["ms"] = row["prev_ms"] = 0.0
        for _ in range(2):
            row["ms"] += cuda_ms(new, 10) / 2
            row["prev_ms"] += cuda_ms(old, 10) / 2
    else:
        row["ms"] = cuda_ms(new, 10)
    row["device_ms"] = graph_ms(new, launches=5, reps=4)
    row["plain_ms"] = cuda_ms(lambda: ba.ba_solve_plain(
        cam, prob, iters, robust, lam0, accept_all), plain_reps)
    row["bound_ms"], row["bound_by"] = bound_ba(prob, iters)
    if iters and time_baseline:
        row["phases_ms"] = ba_phases(cam, prob, iters, robust, lam0,
                                     accept_all)
        # the factorization and solve of one iteration inside the kernel,
        # beside the library's solve of the same float64 S
        row["factorize_ms"] = row["phases_ms"]["factorize"] / iters
    if iters:
        row["factorize_library_ms"] = cuda_ms(
            lambda: torch.linalg.solve_ex(first.S64, first.b64), 10)
    prev = (f", ba_v1 {row['prev_ms']:.4f} ms per call in turns"
            if time_baseline else "")
    phases = ", ".join(f"{k} {v:.4f}" for k, v in row.get(
        "phases_ms", {}).items())
    log(f"K4 {where} [P {P} ({counts['free_poses']} free), L {L}, D {D}, "
        f"{counts['active']} active observations, {counts['pairs']} free "
        f"pairs, {iters} iterations{', accept_all' if accept_all else ''}, "
        f"grid {row['grid']}]: first S within {e_S / scale:.2e} of max |S| "
        f"(the plain float32 system {S_floor / scale:.2e}); first step "
        f"{e_step:.2e} from float64 (bound {step_tol:.2e}, condition "
        f"{kappa:.3g}); accepted {mine[:, 2].tolist()} ({flips} flips); max "
        f"|dR|,|dt|,|dX| {err:.2e}, {err64:.2e} from float64 (the plain "
        f"float32 solve {floor:.2e}); one launch, bit-identical twice; "
        f"{row['ms']:.4f} ms per call, {row['device_ms']:.4f} on the device"
        f"{prev}; plain {row['plain_ms']:.4f}; bound {row['bound_ms']:.6f} "
        f"by {row['bound_by']}"
        + (f"; phases (ms, stamps) {phases}; one factorization and solve "
           f"{row['factorize_ms']:.4f}" if phases else "")
        + (f"; torch.linalg.solve_ex on the float64 S "
           f"{row['factorize_library_ms']:.4f} per call" if iters else ""))
    return row, err


BA_REPLACES = ("orb_slam2_with_comment_tpu/optim/ba.py:208 (ba_solve's "
               "lax.scan, its body :246-335 with the solve at :323, an XLA "
               "program; not a Pallas kernel)")


def check_ba_kernel(dev) -> dict:
    """Phase 3, K4: the BA kernel held against the plain solver and timed
    (hold_ba) on random local-BA problems (dataio.synthetic ba_problem):
    24 poses (8 fixed) and 8192 landmarks (the factorization in shared
    memory), 64 poses and 10,000 landmarks (56 free: from global memory),
    8 poses with every step taken (accept_all, the distributed schedule),
    and 2 poses over 20 iterations (no outliers: a landmark that an
    outlier contradicts runs off toward infinity over 20 iterations, where
    float32 and float64 solves of the plain version already part by
    metres). Returns the kernel's row."""
    rows, err = [], 0.0
    for where, case, seed, kw, iters, accept_all in (
            ("random, 24 poses, 8192 landmarks", "mixed", 0,
             dict(P=24, L=8192), 5, False),
            ("random, 64 poses, 10000 landmarks", "mixed", 1,
             dict(P=64, L=10000), 5, False),
            ("random, 8 poses, accept_all", "mixed", 2,
             dict(P=8, L=4096, n_fixed=1), 8, True),
            ("random, 2 poses, 20 iterations", "mixed", 3,
             dict(P=2, L=500, n_fixed=1, outliers=0.0), 20, False)):
        p = synthetic.ba_problem(case, seed, **kw)
        prob = ba.BAProblem(*(torch.as_tensor(p[f]).to(dev)
                              for f in ba.BAProblem._fields))
        row, e = hold_ba(where, (POSE_CAM, prob, iters, True, 1e-4,
                                 accept_all))
        rows.append(row)
        err = max(err, e)
    return dict(rows[0], name="ba_solve", route="cuda",
                source="orb_slam2_with_comment_tpu_torch/csrc/ba.cu",
                baseline={"name": "ba_v1", "source": "orb_slam2_with_"
                          "comment_tpu_torch/csrc/ba_v1.cu"},
                replaces=BA_REPLACES, library_ms=None, max_abs_err=err,
                other_problems=rows[1:])


# ---------------------------------------------------------------------------
# phase 3, every kernel beyond its first variant's shapes (csrc/*.cu's
# variants, chosen by shape in the wrappers)
# ---------------------------------------------------------------------------

SRC = "orb_slam2_with_comment_tpu_torch/csrc/"
ORB_REPLACES = ("orb_slam2_with_comment_tpu/frontend/extractor.py:118 (XLA "
                "ops, :118-203, on ops/{fast,image,orientation,brief}.py; "
                "not a Pallas kernel)")
SAD_REPLACES = ("orb_slam2_with_comment_tpu/frontend/stereo.py:34 "
                "(_sad_refine_block, an XLA program a level, called at "
                ":135) and the tail at :141-161 (not a Pallas kernel)")
POSE_REPLACES = ("orb_slam2_with_comment_tpu/optim/pose_opt.py:82 (an XLA "
                 "program, :82-176; not a Pallas kernel)")
# the extractor of phase 18's stereo front end: 24 levels of upstream
# ORB-SLAM2's 30 px cells, at the KITTI camera
BEYOND_EXT = dict(n_features=2000, n_levels=24, cell=30)


def hold_best_two_key64(dev) -> dict:
    """K1 above 2^22 targets ([4 x 4,194,321], about 1% admissible, two
    columns tied on either side of 2^22, a row with no candidate): the
    64-bit key's instantiation against masked_best_two_plain bit for bit,
    then timed beside its bound and the plain version."""
    gen = torch.Generator().manual_seed(17)
    n = hamming.NARROW_TARGETS + 17
    dq = random_desc(gen, 4).to(dev)
    dt = random_desc(gen, n).to(dev)
    mask = torch.rand((4, n), generator=gen).lt(0.01).to(dev)
    dt[n - 5] = dq[0]
    dt[7] = dq[0]
    mask[0, [7, n - 5]] = True
    mask[3] = False
    before = hamming.VARIANT_LAUNCHES["masked_best_two_key64"]
    got = hamming.masked_best_two(dq, dt, mask)
    assert hamming.VARIANT_LAUNCHES["masked_best_two_key64"] == before + 1
    want = hamming.masked_best_two_plain(dq, dt, mask)
    err = assert_same("masked_best_two (64-bit key)", got, want,
                      f"[4,{n}]")
    assert int(got[1][0]) == 7 and int(got[3][0]) == n - 5
    row = {"problem": f"random [4,{n}], 1%", "max_abs_err": err,
           "ms": cuda_ms(lambda: hamming.masked_best_two(dq, dt, mask), 20),
           "device_ms": graph_ms(lambda: hamming.masked_best_two(
               dq, dt, mask), launches=5, reps=4),
           "plain_ms": cuda_ms(lambda: hamming.masked_best_two_plain(
               dq, dt, mask), 3)}
    row["bound_ms"], row["bound_by"] = bound_best_two(dq, dt, mask,
                                                      popc_per_s())
    log(f"masked_best_two, 64-bit key, [4,{n}]: bit-exact; " +
        f"{row['ms']:.4f} ms per call, {row['device_ms']:.4f} on the "
        f"device; plain {row['plain_ms']:.4f}; bound {row['bound_ms']:.6f} "
        f"ms by {row['bound_by']}")
    return dict(row, name="hamming_masked_best_two_key64", route="cuda",
                variant_key="masked_best_two_key64", source=SRC + "hamming.cu",
                replaces="orb_slam2_with_comment_tpu/ops/hamming_pallas.py:59",
                library_ms=None)


def bound_orb_chain(levels, per_cell: int) -> tuple:
    """The three ORB kernels' bounds of one view, summed (each a launch
    after the other), by the one that bounds the most of them."""
    parts = [bound_orb(k, levels, per_cell=per_cell) for k in orb.LAUNCHES]
    by = max(("bytes", "operations"),
             key=lambda b: sum(ms for ms, w in parts if w == b))
    return sum(ms for ms, _ in parts), by


def hold_orb_variant(name, pyr, ext, variant_key) -> tuple:
    """K2 at a shape beyond its first variant's: orb_cells (or
    orb_cells_any) and orb_select against their plain versions bit for bit,
    orb_describe to hold_describe's gates with the angles held on the valid
    slots (the keypoints; at 140,000 slots, 139,000 of them invalid at
    zero-candidate positions, an invalid slot's angle differed by 1.6e-4
    where its moments keep 1e-3 of their terms: the 1e-4 gate bounds the
    samples of a thousand slots, not the float32 rounding of any slot; the
    invalid slots' largest difference is logged), the chain against the
    plain chain and two chains bit for bit; the chain then timed per view
    beside the plain chain. Returns (row, largest held angle
    difference)."""
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales), ext.cell)
    flat = orb.pack(pyr)
    pc = ext.per_cell
    before = orb.VARIANT_LAUNCHES[variant_key]
    want = orb.cells_plain(flat, levels, per_cell=pc)
    got = orb.cells(flat, levels, per_cell=pc)
    for part, a, b in zip(("score", "blurred"), got[:2], want[:2]):
        for lv in levels:
            assert torch.equal(orb._view(a, lv), orb._view(b, lv)), \
                f"orb_cells {part} differs at {name}, level {lv.lvl}"
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]), \
        f"orb_cells candidates differ at {name}"
    score, blurred, cand_v, cand_i = want
    want_s = orb.select_plain(cand_v, cand_i, levels)
    for part, a, b in zip(("yx", "response", "valid"),
                          orb.select(cand_v, cand_i, levels), want_s):
        assert torch.equal(a, b), f"orb_select {part} differs at {name}"
    yx, valid = want_s[0], want_s[2]
    kept = orb.moment_cancellation(flat, yx, levels) >= 1e-3
    err, dang, rows, bits, n_rows = hold_describe(
        "orb_describe", orb.describe(flat, score, blurred, yx, levels),
        orb.describe_plain(flat, score, blurred, yx, levels), valid,
        kept & valid, True, name)
    out = kept & ~valid
    err_invalid = float(dang[out].max()) if bool(out.any()) else 0.0
    assert orb.VARIANT_LAUNCHES[variant_key] > before, \
        f"{variant_key} not launched at {name}"

    def chain():
        return orb.extract_levels(pyr, ext.budgets, ext.scales, ext.margin,
                                  ext.th_high, ext.th_low, flat, ext.cell,
                                  pc)
    a, b = chain(), chain()
    plain = orb.extract_levels_plain(flat, levels, ext.margin, ext.th_high,
                                     ext.th_low, pc)
    for part, x, y, z in zip(("xy", "response", "octave", "angle", "desc",
                              "valid"), a, b, plain):
        assert torch.equal(x, y), f"two ORB chains differ in {part} at {name}"
        if part in ("xy", "response", "octave", "valid"):
            assert torch.equal(x, z), f"the ORB chain's {part} at {name}"
    row = {"problem": name, "levels": len(levels), "cell": ext.cell,
           "per_cell": pc, "slots": orb.n_slots(levels),
           "largest_budget": max(lv.budget for lv in levels),
           "n_valid": int(valid.sum()), "max_abs_err": err,
           "invalid_slots_angle_err": err_invalid,
           "differing_valid_descriptor_rows": n_rows,
           "ms": cuda_ms(chain, 20), "device_ms": graph_ms(chain, 10, 5),
           "plain_ms": cuda_ms(lambda: orb.extract_levels_plain(
               flat, levels, ext.margin, ext.th_high, ext.th_low, pc), 3)}
    row["bound_ms"], row["bound_by"] = bound_orb_chain(levels, pc)
    log(f"K2 {name} [{len(levels)} levels, cell {ext.cell}, {pc} a cell, "
        f"largest budget {row['largest_budget']}]: candidates, yx, "
        f"response, valid, octave and xy identical, two chains identical, "
        f"coarser angles within {err:.3g} on valid slots ({err_invalid:.3g} "
        f"on the invalid ones), descriptor rows differing "
        f"{int(rows.sum())} ({n_rows} valid, at most "
        f"{int(bits.max()) if len(bits) else 0} bits); the chain "
        f"{row['ms']:.4f} ms per view, {row['device_ms']:.4f} on the device;"
        f" plain chain {row['plain_ms']:.4f}; bound {row['bound_ms']:.6f} "
        f"ms by {row['bound_by']}")
    return row, err


def hold_sad_variant(where, args, bf, fx) -> dict:
    """K5 at a shape beyond its first instantiation's (more than 16 levels,
    levels under 11 x 21): u_right and depth against stereo_depth_plain in
    bits, the best SAD, ok and the best shift against sad_refine_plain in
    bits, two launches in bits; then timed beside the plain version."""
    flat_l, flat_r, levels, xy, xy_r, best_d, best_j = args
    lay = sad.layout(levels)
    n = lay.n
    got = sad.stereo_depth(*args, bf, fx)
    out = sad.launch_depth(sad._kernel_lib(), lay, flat_l, flat_r, xy, xy_r,
                           best_d, best_j, bf, fx)
    inter = sad.outputs(out, n)
    want = sad.stereo_depth_plain(*args, bf, fx)
    u_r0 = xy_r[best_j.long(), 0]
    ref = sad.sad_refine_plain(flat_l, flat_r, levels, xy, u_r0)
    curves = sad.sad_curves_plain(flat_l, flat_r, levels, xy, u_r0)
    for part, a, b in (("u_right", got[0], want[0]),
                       ("depth", got[1], want[1]),
                       ("u_right again", inter["u_right"], want[0]),
                       ("best SAD", inter["sad"], ref[1]),
                       ("ok", inter["ok"], ref[2]),
                       ("best shift", inter["best"].long(),
                        curves.argmin(1))):
        assert torch.equal(_bits(a), _bits(b)), \
            f"stereo_depth: {part} is not the plain version's bits at {where}"
    small = [lv for lv in levels if lv.h < sad.PATCH or lv.w < sad.SPAN]
    row = {"problem": where, "N": n, "levels": len(levels),
           "small_levels": len(small), "n_good": int((want[1] > 0).sum()),
           "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: sad.stereo_depth(*args, bf, fx), 50),
           "device_ms": graph_ms(lambda: sad.stereo_depth(*args, bf, fx)),
           "plain_ms": cuda_ms(lambda: sad.stereo_depth_plain(*args, bf, fx),
                               5)}
    row["bound_ms"], row["bound_by"] = bound_sad(n)
    log(f"stereo_depth {where} [{n} keypoints, {len(levels)} levels, "
        f"{len(small)} under 11 x 21, {row['n_good']} with depth]: the "
        f"plain version's bits, two launches too; {row['ms']:.4f} ms per "
        f"call, {row['device_ms']:.4f} on the device; plain "
        f"{row['plain_ms']:.4f}; bound {row['bound_ms']:.6f} ms by "
        f"{row['bound_by']}")
    return row


def check_variants(dev) -> list:
    """Phase 3, each kernel beyond its first variant's shapes, held with
    its kernel's gates and timed: K4 at P 24 / L 8192 with D 48 and D 64,
    the observations spread over every slot (the wide variant, hold_ba);
    K3 at [1 x 65,536] and [3 x 65,536] (a cluster of 16) and [1 x
    131,072] (the edges from global memory; hold_pose); K2 at 24 levels
    (the table in device memory), at 30 px cells and at 16 px cells of 4
    (orb_cells_any), 24 levels of 30 px cells (BEYOND_EXT), and 140,000
    features at 2560x1440 (level 0's 30,427 slots above orb_select's
    shared memory: its global scratch); K5 at 24 levels of the KITTI pair
    (the table in device memory, levels 20-23 under 11 rows) and at 24
    levels with a 4 px margin at 640x480 (keypoints on levels under 11
    rows); K1 at [4 x 4,194,321] (the 64-bit key). Returns one row a
    variant."""
    rows = []
    timed, err = [], 0.0
    for D in (48, 64):
        p = synthetic.ba_problem("mixed", 20 + D, P=24, L=8192, D=D,
                                 spread=True)
        prob = ba.BAProblem(*(torch.as_tensor(p[f]).to(dev)
                              for f in ba.BAProblem._fields))
        before = ba.VARIANT_LAUNCHES["ba_solve_wide"]
        row, e = hold_ba(f"random, 24 poses, 8192 landmarks, {D} slots "
                         "spread", (POSE_CAM, prob, 5, True, 1e-4, False),
                         time_baseline=False)
        assert ba.VARIANT_LAUNCHES["ba_solve_wide"] > before
        timed.append(row)
        err = max(err, e)
    rows.append(dict(timed[0], name="ba_solve_wide", route="cuda",
                     variant_key="ba_solve_wide", source=SRC + "ba.cu",
                     replaces=BA_REPLACES, library_ms=None, max_abs_err=err,
                     other_problems=timed[1:]))
    for key, shapes in (("pose_lm_cluster16", ((1, 65536), (3, 65536))),
                        ("pose_lm_stream", ((1, 131072),))):
        timed, err = [], 0.0
        for i, (b, n) in enumerate(shapes):
            p = pose_problem("outliers", 500 + i, b, n)
            args = (POSE_CAM, *(torch.as_tensor(p[k]).to(dev) for k in (
                "R0", "t0", "Xw", "obs_uvr", "inv_sigma2", "valid")))
            before = pose_opt.VARIANT_LAUNCHES[key]
            row, e = hold_pose(f"random {b}x{n}", args)
            assert pose_opt.VARIANT_LAUNCHES[key] > before, key
            timed.append(row)
            err = max(err, e)
        rows.append(dict(timed[0], name=key, route="cuda", variant_key=key,
                         source=SRC + "pose_lm.cu", replaces=POSE_REPLACES,
                         max_abs_err=err, library_ms=None,
                         other_problems=timed[1:]))
    kitti = first_frames("kitti30_left", 1)[0]
    f0 = first_frames("orbit60", 1)[0][0]
    w, h = 2560, 1440
    f = 500.0 * w / 640.0
    big = render_job((0.0, [orbit_trajectory(n_frames=60)[7]],
                      dict(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h),
                      "image"), dev)[0]
    for key, cases in (
            ("orb_far", [("KITTI camera, 1241x376, 2000, 24 levels", kitti,
                          dict(n_features=2000, n_levels=24))]),
            ("orb_cells_any", [
                ("KITTI camera, 1241x376, 2000, 30 px cells", kitti,
                 dict(n_features=2000, cell=30)),
                ("KITTI camera, 1241x376, 2000, 24 levels of 30 px cells",
                 kitti, BEYOND_EXT),
                ("orbit frame 0, 640x480, 1000, 16 px cells of 4", f0,
                 dict(n_features=1000, cell=16, per_cell=4))]),
            ("orb_select_global", [("2560x1440, 140000", big,
                                    dict(n_features=140000))])):
        timed, err = [], 0.0
        for name, img, kw in cases:
            ext = OrbExtractor(**kw)
            pyr = ext._pyramid(torch.as_tensor(img, device=dev))
            row, e = hold_orb_variant(name, pyr, ext, key)
            timed.append(row)
            err = max(err, e)
        rows.append(dict(timed[0], name=key, route="cuda", variant_key=key,
                         source=SRC + "orb.cu", replaces=ORB_REPLACES,
                         max_abs_err=err, library_ms=None,
                         other_problems=timed[1:]))
    kl, kr = (first_frames(s, 1)[0] for s in ("kitti30_left",
                                              "kitti30_right"))
    left = first_frames("orbit60", 1)[0][0]
    right = first_frames("orbit60_right", 1)[0]
    timed = []
    for where, l_img, r_img, bf, fx, kw in (
            ("KITTI camera, 1241x376, 2000, 24 levels of 30 px cells", kl,
             kr, bench.KITTI_BF, bench.KITTI_CAM["fx"], BEYOND_EXT),
            ("bench pair, 640x480, 2000, 24 levels, 4 px margin", left,
             right, 40.0, 500.0, dict(n_levels=24, margin=4))):
        bf, fx = sad._f32(bf), sad._f32(fx)
        n = kw.get("n_features", 2000)
        kw = {k: v for k, v in kw.items() if k != "n_features"}
        ins = sad_inputs(dev, l_img, r_img, n, bf, fx, None, **kw)
        before = dict(sad.VARIANT_LAUNCHES)
        timed.append(hold_sad_variant(where, ins[:7], bf, fx))
        assert all(sad.VARIANT_LAUNCHES[k] > before[k]
                   for k in sad.VARIANT_LAUNCHES), where
    rows.append(dict(timed[0], name="stereo_sad_far", route="cuda",
                     variant_key="stereo_sad_far", source=SRC +
                     "stereo_sad.cu", replaces=SAD_REPLACES, library_ms=None,
                     other_problems=timed[1:]))
    rows.append(hold_best_two_key64(dev))
    return rows


def fmt_times(row: dict) -> str:
    return (f"kernel {row['ms']:.4f} ms per call, {row['device_ms']:.4f} ms "
            f"on the device; baseline kernel {row['prev_ms']:.4f} and "
            f"{row['prev_device_ms']:.4f}; plain {row['plain_ms']:.4f}; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}")


# feature extractions, one per frame, the views on the card they
# extracted, one per frame or two per stereo frame, the stereo pairs
# extracted on the card, and the dense BA solves on the card (count_frames)
FRAMES = {"frames": 0, "views": 0, "pairs": 0, "ba_solves": 0}


def launch_counts() -> dict:
    """Each kernel entry point's launches since reset_launches(), "frames":
    the frames whose features were extracted meanwhile, "views": the
    views extracted on the card, "pairs": the stereo pairs among them,
    "ba_solves": the dense BA solves on the card."""
    return {**hamming.LAUNCHES, **mcore.LAUNCHES, **pose_opt.LAUNCHES,
            **orb.LAUNCHES, **sad.LAUNCHES, **ba.LAUNCHES,
            **hamming.VARIANT_LAUNCHES, **mcore.VARIANT_LAUNCHES,
            **pose_opt.VARIANT_LAUNCHES, **orb.VARIANT_LAUNCHES,
            **sad.VARIANT_LAUNCHES, **ba.VARIANT_LAUNCHES, **FRAMES}


def set_launches(counts: dict):
    for c in (hamming.LAUNCHES, mcore.LAUNCHES, pose_opt.LAUNCHES,
              orb.LAUNCHES, sad.LAUNCHES, ba.LAUNCHES,
              hamming.VARIANT_LAUNCHES, mcore.VARIANT_LAUNCHES,
              pose_opt.VARIANT_LAUNCHES, orb.VARIANT_LAUNCHES,
              sad.VARIANT_LAUNCHES, ba.VARIANT_LAUNCHES, FRAMES):
        for k in c:
            c[k] = counts[k]


def reset_launches():
    set_launches(dict.fromkeys(launch_counts(), 0))


def count_frames():
    """Every frame of every path goes through OrbExtractor._extract (RGB-D,
    mono) or OrbExtractor.stereo (a rectified pair) once: each call adds
    one to FRAMES["frames"] for the rest of the run, and a pair on the
    card one to FRAMES["pairs"]. Every view goes through
    OrbExtractor._extract_from_pyramid once: one on the card adds one to
    FRAMES["views"]. Every dense BA solve goes through ba.ba_solve: one on
    the card adds one to FRAMES["ba_solves"]."""
    def counted(fn):
        def run(*a, **kw):
            FRAMES["frames"] += 1
            return fn(*a, **kw)
        return run

    extract_view = OrbExtractor._extract_from_pyramid
    extract_pair = OrbExtractor.stereo
    solve = ba.ba_solve

    def counted_view(self, pyr, *a):
        FRAMES["views"] += pyr[0].is_cuda
        return extract_view(self, pyr, *a)

    def counted_pair(self, img_l, *a, **kw):
        FRAMES["frames"] += 1
        FRAMES["pairs"] += img_l.is_cuda
        return extract_pair(self, img_l, *a, **kw)

    def counted_solve(cam, prob, iters=10, *a, **kw):
        FRAMES["ba_solves"] += prob.X.is_cuda
        return solve(cam, prob, iters, *a, **kw)
    OrbExtractor._extract = counted(OrbExtractor._extract)
    OrbExtractor.stereo = counted_pair
    OrbExtractor._extract_from_pyramid = counted_view
    ba.ba_solve = counted_solve


def check_k2_per_view(by_phase: dict):
    """Every path extracted each view on the card with one launch of each
    K2 kernel: 3 per view, 6 per stereo frame."""
    for phase, c in by_phase.items():
        assert c["views"] > 0, f"{phase}: no view extracted on the card"
        for k in orb.LAUNCHES:
            assert c[k] == c["views"], \
                f"{phase}: {c[k]} {k} launches for {c['views']} views"
    log("K2 launches per frame by phase (3 kernels each): "
        f"{ {p: per_frame(c, 'orb_cells') for p, c in by_phase.items()} }")


def check_k5_per_pair(by_phase: dict):
    """Every path refined each stereo pair it extracted on the card with
    one stereo_sad launch, and no other path launched it."""
    for phase, c in by_phase.items():
        assert c["stereo_sad"] == c["pairs"], \
            f"{phase}: {c['stereo_sad']} stereo_sad launches for " \
            f"{c['pairs']} stereo pairs"
    log("K5 launches per frame by phase: "
        f"{ {p: per_frame(c, 'stereo_sad') for p, c in by_phase.items()} }")


# the paths whose keyframe maintenance surely runs a local BA: each
# inserts keyframes that share landmarks
K4_PATHS = ("4 rgbd slice", "6 default rgbd", "9 stereo bench",
            "11 mono bench", "13a system rgbd", "16c street", "17 bench")


def check_k4_per_solve(by_phase: dict):
    """Every dense BA solve on the card was one ba_solve launch; the paths
    of K4_PATHS ran solves."""
    for phase, c in by_phase.items():
        assert c["ba_solve"] == c["ba_solves"], \
            f"{phase}: {c['ba_solve']} ba_solve launches for " \
            f"{c['ba_solves']} dense BA solves"
    for phase in K4_PATHS:
        assert by_phase[phase]["ba_solves"] > 0, \
            f"{phase}: no dense BA solve on the card"
    log("K4 launches (one a dense BA solve) by phase: "
        + str({p: c["ba_solve"] for p, c in by_phase.items()}))


def missing(launches: dict, stereo: bool = False) -> list:
    """The kernels of K1-K3, and K5 on a stereo path, that ``launches``
    does not count; K4 is held per solve by check_k4_per_solve."""
    names = [*hamming.LAUNCHES, *pose_opt.LAUNCHES, *orb.LAUNCHES]
    return [k for k in names + ([*sad.LAUNCHES] if stereo else [])
            if launches[k] == 0]


def k1_launches(counts: dict) -> int:
    """K1's launches in ``counts``, both entry points."""
    return sum(counts[k] for k in hamming.LAUNCHES)


def per_frame(counts: dict, key: str) -> float | None:
    return (round(counts[key] / counts["frames"], 3) if counts.get("frames")
            else None)


def bench_cfg(map_cfg=BENCH_MAP):
    """The bench configuration (bench.py:74-77)."""
    return TrackerConfig(n_features=1000, min_init_features=200,
                         map_cfg=map_cfg, fps=30, depth_factor=1.0 / 5000.0)


def synced_ms(fn) -> float:
    """Host-clock ms of fn() between two device syncs."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)  # a rehearsal of a phase on the CPU
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return 1000 * (time.perf_counter() - t0)


REDUCED_CAM = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320,
                   height=240)
BENCH_BASELINE = 40.0 / 500.0  # bf / fx of the bench configuration
MONO_SEQ = "orbit60"  # the sequence phase 11 tracks (its images only)
MULTI_FRAMES = 20  # the frames phase 15a tracks in each of its two worlds


def right_view(poses, baseline: float):
    """The poses of a right camera ``baseline`` metres along the x axis."""
    shift = np.array([baseline, 0, 0], np.float32)
    return [(R, np.asarray(t, np.float32) - shift) for R, t in poses]


def sequences() -> dict:
    """Every synthetic sequence the phases track, by name: (depth noise,
    poses, camera, what a frame holds: "rgbd" = (uint8 image, uint16 depth
    at 5000 per metre), "image" = uint8 image, "raw" = the renderer's
    float image and depth[, the world's seed when it is not 1])."""
    orbit60 = orbit_trajectory(n_frames=60)
    lap = orbit_trajectory(n_frames=14)
    kitti30 = orbit60[:30]
    return {
        "orbit60": (0.0, orbit60, {}, "rgbd"),
        "orbit60_right": (0.0, right_view(orbit60, BENCH_BASELINE), {},
                          "image"),
        "reduced16": (0.0, orbit_trajectory(n_frames=16), REDUCED_CAM,
                      "rgbd"),
        "loop18": (0.0, lap + lap[:4], {}, "raw"),
        # the same lap, revisited from 15 cm to the right: a Sim3 between
        # two keyframes at one camera center leaves its scale unobservable
        "loop18_shifted": (0.0, lap + right_view(lap[:4], 0.15), {}, "raw"),
        "pressure40": (0.0, orbit_trajectory(n_frames=40), {}, "rgbd"),
        "noisy40": (0.02, orbit60[:40], {}, "rgbd"),
        "kitti30_left": (0.0, kitti30, bench.KITTI_CAM, "image"),
        "kitti30_right": (0.0, right_view(
            kitti30, bench.KITTI_BF / bench.KITTI_CAM["fx"]),
            bench.KITTI_CAM, "image"),
        # phase 15a's second world: the orbit's first frames, seed 0
        "orbit_seed0": (0.0, orbit60[:MULTI_FRAMES], {}, "rgbd", 0),
    }


def render_job(job, device=None):
    """Render one sequence, in order, from one SyntheticWorld (seed 1
    unless the job names another): with numpy, or on the torch ``device``
    16 views a batch (synthetic.render_views: a few pixels of a frame one
    grey level apart; depth noise drawn on the host in the same order)."""
    noise, poses, cam, kind, *seed = job
    world = SyntheticWorld(seed=seed[0] if seed else 1, depth_noise=noise)
    if device is None:
        views = [world.render(R, t, **cam) for R, t in poses]
    else:
        views = [v for i in range(0, len(poses), 16)
                 for v in synthetic.render_views(world, poses[i:i + 16],
                                                 device, **cam)]
    out = []
    for img, depth in views:
        if kind == "raw":
            out.append((img, depth))
            continue
        img = np.clip(img, 0, 255).astype(np.uint8)
        out.append(img if kind == "image" else (
            img, np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)))
    return out


_FRAMES: dict = {}


def frames_of(name: str):
    """A sequence's frames: rendered by render_all, or here on first use
    (a rehearsal of one phase)."""
    if name not in _FRAMES:
        _FRAMES[name] = render_job(sequences()[name])
    return _FRAMES[name]


def first_frames(name: str, n: int):
    """The first ``n`` frames of a sequence without depth noise: of the
    rendered ones, or rendered here alone (the kernels-only run renders
    nothing else)."""
    if name in _FRAMES:
        return _FRAMES[name][:n]
    noise, poses, cam, kind, *seed = sequences()[name]
    assert noise == 0.0, "a noisy sequence draws from one stream, in order"
    return render_job((noise, poses[:n], cam, kind, *seed))


def render_all(workers: int, chunk: int = 5, names=None, device=None):
    """Render every sequence (or those in ``names``) on the torch
    ``device``, or else in ``workers`` processes (a numpy render takes
    longer than a tracked frame). Sequences without depth noise are cut
    into chunks; the noisy one draws from one random stream, in order."""
    todo = {k: v for k, v in sequences().items()
            if names is None or k in names}
    if device is not None:
        for name, job in todo.items():
            _FRAMES[name] = render_job(job, device)
        return
    jobs = []
    for name, (noise, poses, cam, kind, *seed) in todo.items():
        step = len(poses) if noise > 0 else chunk
        jobs += [(name, i, (noise, poses[i:i + step], cam, kind, *seed))
                 for i in range(0, len(poses), step)]
    # the longest jobs first: the noisy sequence is one job of 40 frames
    jobs.sort(key=lambda j: -len(j[2][1]) * j[2][2].get("width", 640))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        parts = list(pool.map(render_job, [job for _, _, job in jobs]))
    done = sorted(zip(jobs, parts), key=lambda jp: jp[0][:2])
    for name in todo:
        _FRAMES[name] = [f for (n, _, _), part in done if n == name
                         for f in part]


def run_slice(dev):
    """Phase 4: the full-width RGB-D slice, counted launches, timed passes.
    Returns (the launches, the newest problem of each calling function and
    shape the kernels were given)."""
    n, n_again = 60, 30
    poses = orbit_trajectory(n_frames=n)
    frames = frames_of("orbit60")
    tracker = AutoTracker(bench_cfg(), AutoTrackerConfig(
        traj_capacity=8 * n, loop_closing=False), device=dev)
    reset_launches()
    with captured_problems() as problems:
        for k, count in enumerate((n, n_again)):
            ms, wall = bench.timed_pass(tracker, tracker.process_rgbd,
                                        frames[:count])
            log(f"slice pass {k + 1} ({count} frames): {ms:.3f} ms/frame "
                f"(CUDA events), {wall:.3f} ms/frame (host clock)")
    launches = launch_counts()
    out = tracker.finalize()
    log(f"slice: initialized={out['initialized']} lost_at={out['lost_at']} "
        f"valid={int(out['valid'].sum())}/{n + n_again} keyframes="
        f"{out['n_keyframes']} inserted at "
        f"{np.nonzero(out['stats'][:, 6])[0].tolist()} launches={launches}")
    assert out["initialized"] and out["lost_at"] == -1, "tracking lost"
    assert out["valid"].shape == (n + n_again,) and out["valid"].all(), \
        "not every frame of both passes valid"
    assert 3 <= out["n_keyframes"] <= 24, out["n_keyframes"]
    for p, count in enumerate((n, n_again)):
        t_med, r_med = bench.pose_errors(out, poses[:count], offset=p * n)
        log(f"pass {p + 1}: median t err {t_med:.5f} m, rot err "
            f"{r_med:.4f} deg")
        assert t_med < 0.02 and r_med < 1.0, "pose error gate"
    assert not missing(launches), \
        f"kernels {missing(launches)} never launched on the main path"
    # every frame but the first (the initialization) tracks: the batched
    # B = 3 solve (or the reference-keyframe solve) and the local-map solve
    tracked = int(out["valid"].sum()) - 1
    log(f"slice: pose_lm {launches['pose_lm']} launches over {tracked} "
        f"tracked frames, {per_frame(launches, 'pose_lm')} per frame")
    assert launches["pose_lm"] >= 2 * tracked, \
        "fewer than two pose LM launches per tracked frame"
    return launches, problems


def compare_devices(dev):
    """Phase 5: the reduced slice on the card against the plain CPU run."""
    cam = REDUCED_CAM
    frames = frames_of("reduced16")
    outs = []
    for device in (dev, "cpu"):
        cfg = TrackerConfig(
            **cam, bf=20.0, n_features=500, min_init_features=100, fps=30,
            depth_factor=1.0 / 5000.0,
            map_cfg=MapConfig(k_max=8, n_feat=500, l_max=3000, d_max=8))
        tr = AutoTracker(cfg, AutoTrackerConfig(loop_closing=False),
                         device=device)
        for img, depth in frames:
            tr.process_rgbd(img, depth)
        outs.append(tr.finalize())
    gpu, cpu = outs
    ins_g = np.nonzero(gpu["stats"][:, 6])[0].tolist()
    ins_c = np.nonzero(cpu["stats"][:, 6])[0].tolist()
    dt = float(np.abs(gpu["t"] - cpu["t"]).max())
    log(f"card vs cpu (reduced slice): inserts {ins_g} vs {ins_c}, "
        f"valid {int(gpu['valid'].sum())} vs {int(cpu['valid'].sum())}, "
        f"max |t| diff {dt:.2e} m")
    assert ins_g == ins_c and (gpu["valid"] == cpu["valid"]).all()
    assert dt < 1e-3, "card and CPU poses differ"


def run_default(dev):
    """Phase 6: AutoTrackerConfig() at the bench configuration, with a
    kidnap (3 black frames) and a revisit that must relocalize."""
    n = 60
    poses = orbit_trajectory(n_frames=n)
    frames = frames_of("orbit60")
    black = (np.zeros((480, 640), np.uint8), np.zeros((480, 640), np.uint16))
    seq = frames + [black] * 3 + frames[2:5]
    r = n + 3  # the first revisit frame
    box = {}
    ctor_ms = synced_ms(lambda: box.setdefault("t", AutoTracker(
        bench_cfg(), AutoTrackerConfig(), device=dev)))
    tracker = box["t"]
    log(f"default tracker: built in {ctor_ms:.2f} ms (the vocabulary's "
        f"load and the forward-mode AD warm-up, the first in this run)")
    n_phases = len(tracker._step.maint_phases)
    assert n_phases == 7, "loop closing is not the seventh phase"
    reset_launches()
    loop_ms, build_ms = [], []
    for i, (img, depth) in enumerate(seq):
        s = tracker.state
        may_loop = (s.initialized and s.lost < 0 and s.maint_kf >= 0
                    and s.maint_phase == n_phases - 1)
        before, gen_state = launch_counts(), s.loop.gen.get_state()
        with stage_ms(*(RELOC_STAGES if i == r else ())) as cold:
            ms = synced_ms(lambda: tracker.process_rgbd(img, depth))
        if may_loop and tracker.state.maint_kf < 0:  # ph_loop ran
            loop_ms.append(ms)
        if i < n:
            build_ms.append(ms)
            build_launches = launch_counts()
        if i == r:
            reloc_ms, reloc_cold = ms, cold
            reloc_launches = {k: v - before[k]
                              for k, v in launch_counts().items()}
            # the same frame again from the same state: the warm cost
            reloc_warm = warm_rerun(lambda: tracker._step(
                s, torch.as_tensor(img, device=dev),
                torch.as_tensor(depth.astype(np.int32), device=dev)),
                s.loop.gen, gen_state, RELOC_STAGES)
    launches = launch_counts()
    out = tracker.finalize()
    t_err = float(np.linalg.norm(out["t"][r] - poses[2][1]))
    log(f"default tracker: valid={int(out['valid'].sum())}/{len(seq)} "
        f"keyframes={out['n_keyframes']} lost_at={out['lost_at']} "
        f"loops={out['n_loops_closed']} reloc frame {r}: stats "
        f"{out['stats'][r].tolist()} t err {t_err:.5f} m")
    log(f"default tracker: build frames median {np.median(build_ms):.2f} "
        f"ms; ph_loop frames {[round(v, 2) for v in loop_ms]} ms; "
        f"relocalization frame {reloc_ms:.2f} ms (host clock, synced)")
    log(f"default tracker: relocalization frame by stage (ms, synced): "
        f"first {reloc_cold}, again {reloc_warm}")
    log(f"default tracker launches: run {launches}, the {n} build frames "
        f"{build_launches}, relocalization frame {reloc_launches}")
    assert out["valid"][:n].all(), "a build frame is invalid"
    assert not out["valid"][n:r].any(), "a black frame is valid"
    assert out["valid"][r:].all() and out["stats"][r, 6] == 2, \
        "did not relocalize at the first revisit frame"
    assert t_err < 0.05, "relocalized pose error"
    assert out["lost_at"] == -1
    assert out["n_loops_closed"] == 0, "the JAX package closes no loop here"
    assert loop_ms, "no frame ran the loop-closing phase"
    assert reloc_launches["masked_best_two"] > 0
    assert not missing(launches), \
        f"kernels {missing(launches)} never launched on the main path"
    return launches, build_launches, tracker


@contextlib.contextmanager
def stage_ms(*targets):
    """Within the block, each (module, function name) of ``targets`` adds
    the synced host-clock ms of its calls to the yielded dict (nested
    stages count in their callers too)."""
    out = {}

    def timed(name, fn):
        def run(*a, **kw):
            box = {}
            ms = synced_ms(lambda: box.setdefault("r", fn(*a, **kw)))
            out[name] = round(out.get(name, 0.0) + ms, 2)
            return box["r"]
        return run

    saved = [getattr(mod, name) for mod, name in targets]
    try:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, timed(
                f"{mod.__name__.rsplit('.', 1)[-1]}.{name}", fn))
        yield out
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


RELOC_STAGES = ((steps, "extract_rgbd_features"), (V, "transform"),
                (msearch, "search_brute"), (pnp, "solve_ransac"),
                (steps, "_pose_optimize_from_matches"),
                (steps, "track_local_map"))
LOOP_STAGES = ((auto_loop, "add_keyframe_bow"), (auto_loop, "detect"),
               (auto_loop, "sim3_solve"),
               (auto_loop.sim3solver, "solve_ransac"),
               (auto_loop, "sim3_grow_matches"),
               (auto_loop.sim3_opt, "optimize_sim3"),
               (auto_loop, "sim3_accept_gate"), (auto_loop, "correct_loop"),
               (steps, "loop_search_and_fuse"),
               (auto_loop.pose_graph, "optimize_pose_graph"),
               (auto_loop.pose_graph, "optimize_pose_graph_cg"),
               (auto_loop.ba, "ba_solve"), (auto_loop.ba, "ba_solve_cg"))


def warm_rerun(fn, gen: torch.Generator, gen_state, stages) -> dict:
    """fn() once more with the generator rewound to ``gen_state``, timed
    by stage; the generator and the launch counts are left as they were."""
    after, counts = gen.get_state(), launch_counts()
    gen.set_state(gen_state)
    with stage_ms(*stages) as out:
        fn()
    gen.set_state(after)
    set_launches(counts)
    return out


LOOP_MAP = MapConfig(k_max=20, n_feat=1000, l_max=10000, d_max=8)


def run_controlled_loop(dev, map_cfg=LOOP_MAP, fix_scale=True,
                        label="controlled loop", seq="loop18",
                        drift_gate=0.35, rerun=True):
    """Phases 7 and 12: tests/test_auto_loop.py's controlled loop at full
    width, through keyframe_step + close_loop_step. With fix_scale=False
    the map is monocular (no right coordinates; its landmarks still come
    from the depth image) and keyframes 8-13 also drift in scale, 2% a
    keyframe up to 1.12, as a monocular map drifts: the depths a keyframe
    is given, and its step from the keyframe before it, are multiplied by
    its scale. The keyframes after them keep that scale. ``seq`` names
    the 18 frames: the free-scale run takes the lap revisited from 15 cm
    aside ("loop18_shifted"), because a revisit from the very same camera
    center makes the Sim3's scale unobservable to its refinement.
    ``rerun``: the firing step run once more from the same input and draws
    (its stages and how far it lands from the first)."""
    cfg = TrackerConfig(n_features=1000, min_init_features=200,
                        map_cfg=map_cfg, fps=30, depth_factor=1.0)
    poses = sequences()[seq][1]
    rendered = frames_of(seq)
    ext = OrbExtractor(n_features=1000)
    voc = V.load_default_vocabulary(dev)
    auto_loop.warm_up_autodiff()  # as AutoTracker does (cheap after it)
    cam = cfg.cam
    th_depth = float(np.float32(cfg.depth_threshold))
    m = empty_map(cfg.map_cfg, dev)
    loop = auto_loop.empty_loop_carry(cfg.map_cfg.k_max, 1000, dev)
    drift = np.zeros(3, np.float32)
    scale, scales, center, center_told = 1.0, [], None, None
    events, err_before, fire_ms, stages = [], None, None, {}
    n_edges = []
    edges_fn = auto_loop._essential_edges

    def counted_edges(*a, **kw):
        out = edges_fn(*a, **kw)
        n_edges.append((int(out[2].sum()), out[2].numel()))
        return out

    def kf_scale(m, k):
        """Median ratio of keyframe k's landmark depths in the map to the
        depths the camera measured there."""
        lm = m.kf_lm[k]
        safe = lm.clamp(min=0).long()
        has = (lm >= 0) & m.lm_valid[safe] & (m.kf_depth[k] > 0)
        z = m.lm_pw[safe] @ m.kf_R[k][2] + m.kf_t[k][2]
        return float((z / (m.kf_depth[k] / scales[k]))[has].median())

    reset_launches()
    for k, (R, t) in enumerate(poses):
        img, depth = rendered[k]
        feats, d = steps.extract_rgbd_features(
            ext, cam, torch.as_tensor(np.clip(img, 0, 255).astype(
                np.float32), device=dev),
            torch.as_tensor(depth, device=dev), 1.0, cfg.width, cfg.height)
        if 8 <= k < 14:
            drift = drift + np.float32([0.015, 0.0, 0.008])
            if not fix_scale:
                scale += 0.02
        scales.append(scale)
        t_told = t + drift
        if not fix_scale:
            feats = feats._replace(ur=torch.full_like(feats.ur, -1.0))
            d = torch.where(d > 0, d * np.float32(scale), d)
            c = -R.T @ t
            center_told = c if k == 0 else (
                center_told + np.float32(scale) * (c - center))
            center = c
            t_told = (-R @ center_told + drift).astype(np.float32)
        obs = steps.FrameObs(feats, d, torch.full(
            (d.shape[0],), -1, dtype=torch.int32, device=dev))
        m = steps.keyframe_step(
            m, cam, obs, torch.as_tensor(R, device=dev),
            torch.as_tensor(t_told, device=dev), k, th_depth, cfg.width,
            cfg.height)
        n_before = loop.n_loops
        if err_before is None:
            err_now = float(np.linalg.norm(m.kf_t[k].cpu().numpy()
                                           - poses[k][1]))
            scale_now = kf_scale(m, k)
        box = {}

        def close(loop=loop, m=m, k=k):
            box["r"] = auto_loop.close_loop_step(
                loop, m, cam, k, voc, fix_scale=fix_scale, width=cfg.width,
                height=cfg.height)

        gen_state = loop.gen.get_state()
        before_close = launch_counts()
        auto_loop._essential_edges = counted_edges
        try:
            with stage_ms(*LOOP_STAGES) as cold:
                ms = synced_ms(close)
        finally:
            auto_loop._essential_edges = edges_fn
        m, loop = box["r"]
        if loop.n_loops > n_before:
            events.append(k)
            if err_before is None:
                err_before, fire_ms, stages = err_now, ms, {"first": cold}
                fire_launches = {k: v - before_close[k]
                                 for k, v in launch_counts().items()}
                scale_before = scale_now
                if rerun:
                    # the same step again from the same input and draws
                    stages["again"] = warm_rerun(close, loop.gen, gen_state,
                                                 LOOP_STAGES)
                    # index_add_ sums in no fixed order on the card: what
                    # the same step from the same input and draws gives
                    # twice
                    again = box["r"][0]
                    rerun_diff = (
                        float((again.kf_t - m.kf_t).abs().max()),
                        float((again.lm_pw - m.lm_pw).abs().max()))
    launches = launch_counts()
    assert events, "no loop closed over a perfect revisit"
    k0 = events[0]
    err_after = float(np.linalg.norm(m.kf_t[k0].cpu().numpy() - poses[k0][1]))
    anchor = float(np.abs(m.kf_t[0].cpu().numpy() - poses[0][1]).max())
    log(f"{label} (k_max {map_cfg.k_max}, fix_scale={fix_scale}): fired at "
        f"keyframes {events}, error {err_before:.5f} -> {err_after:.5f} m, "
        f"keyframe 0 moved {anchor:.2e} m, the firing close_loop_step took "
        f"{fire_ms:.2f} ms (host clock, synced), its essential graph has "
        f"{n_edges[0][0]} valid edges of {n_edges[0][1]} listed; launches "
        f"{launches}, of them in the firing step {fire_launches}")
    log(f"{label}: the firing step by stage (ms, synced): {stages}")
    if rerun:
        log(f"{label}: the firing step run twice differs by "
            f"{rerun_diff[0]:.2e} m on keyframe translations, "
            f"{rerun_diff[1]:.2e} m on landmarks")
    if not fix_scale:
        after = {k: round(kf_scale(m, k), 4) for k in range(8, k0 + 1)}
        log(f"{label}: scale of keyframe {k0}'s landmarks {scale_before:.4f} "
            f"-> {after[k0]:.4f}; keyframes 8-{k0} after: {after}")
    assert k0 >= 10 and err_before > (0.05 if fix_scale else 0.03)
    assert err_after < drift_gate * err_before, \
        "loop correction did not reduce drift"
    assert anchor < 1e-3, "keyframe 0 moved"
    assert torch.isfinite(m.kf_t).all() and torch.isfinite(m.lm_pw).all()
    if not fix_scale:
        assert abs(scale_before - 1.0) > 0.08, "no scale error was injected"
        assert all(abs(v - 1.0) < 0.05 for v in after.values()), \
            "the corrected keyframes' scale is not back within 5% of 1"
    # keyframe_step and close_loop_step with given poses: no pose LM here
    for name in hamming.LAUNCHES:
        assert launches[name] > 0, \
            f"kernel {name} never launched on the loop path"
    return launches, fire_ms


def run_compaction(dev):
    """Phase 8: landmark and keyframe slot compaction with loop closing
    on."""
    results = {}
    for name, map_cfg, seq, key in (
            ("landmark pressure", MapConfig(12, 1000, 2500, 8), "pressure40",
             "n_compact_lm"),
            ("noisy depth", MapConfig(12, 1000, 8000, 8), "noisy40",
             "n_compact_kf")):
        poses = sequences()[seq][1]
        frames = frames_of(seq)
        tracker = AutoTracker(bench_cfg(map_cfg), AutoTrackerConfig(
            traj_capacity=len(frames)), device=dev)
        reset_launches()
        for img, depth in frames:
            tracker.process_rgbd(img, depth)
        launches = launch_counts()
        out = tracker.finalize()
        t_med, r_med = bench.pose_errors(out, poses)
        log(f"compaction ({name}): n_compact_lm={out['n_compact_lm']} "
            f"n_compact_kf={out['n_compact_kf']} "
            f"valid={int(out['valid'].sum())}/{len(frames)} keyframe slots "
            f"{out['n_keyframes']} inserted at "
            f"{np.nonzero(out['stats'][:, 6] == 1)[0].tolist()} median t err "
            f"{t_med:.5f} m, rot err {r_med:.4f} deg; launches {launches}")
        assert out[key] >= 1, f"{key} == 0"
        assert out["valid"].all() and out["lost_at"] == -1
        assert t_med < 0.02, "pose error gate"
        results[name] = launches
    return results


STEREO_STAGES = ((OrbExtractor, "stereo"),
                 (OrbExtractor, "_pyramid"),
                 (OrbExtractor, "_extract_from_pyramid"),
                 (stereo, "match_stereo"), (stereo, "association_mask"),
                 (stereo, "_stereo_depth"))


@contextlib.contextmanager
def association_launches():
    """Within the block, each stereo association (frontend/stereo.py
    match_stereo) appends its masked_best_two launches to the yielded
    list: one a stereo frame."""
    out = []
    match_stereo = stereo.match_stereo

    def counted_match(*a, **kw):
        before = hamming.LAUNCHES["masked_best_two"]
        r = match_stereo(*a, **kw)
        out.append(hamming.LAUNCHES["masked_best_two"] - before)
        return r

    stereo.match_stereo = counted_match
    try:
        yield out
    finally:
        stereo.match_stereo = match_stereo


def run_stereo(dev, label, cfg, pairs, poses, n_staged=10):
    """Phases 9 and 10: the default tracker on rectified pairs, built, then
    its first ``n_staged`` frames again with stage timers (the bench's
    stereo figures time the re-tracking passes). Returns (first pass
    launches, finalize()'s result, the tracker, (median t error, frame 0's
    features with depth), the first pass's problems for the kernels)."""
    n = len(pairs)
    # frame 0's features with depth, outside the counted run
    feats, sd = OrbExtractor(n_features=cfg.n_features).stereo(
        *(torch.as_tensor(im, device=dev) for im in pairs[0]), cfg.bf, cfg.fx)
    n_depth0 = int(((sd.depth > 0) & feats.valid).sum())
    tracker = AutoTracker(cfg, AutoTrackerConfig(traj_capacity=8 * n),
                          device=dev)
    reset_launches()
    with association_launches() as match_launches:
        with captured_problems() as problems:
            build = bench.timed_pass(tracker, tracker.process_stereo,
                                     pairs)
        first_launches = launch_counts()
    with stage_ms(*STEREO_STAGES) as staged:
        for pair in pairs[:n_staged]:
            tracker.process_stereo(*pair)
    out = tracker.finalize()
    t_med, r_med = bench.pose_errors(out, poses)
    log(f"{label}: initialized={out['initialized']} lost_at={out['lost_at']} "
        f"valid={int(out['valid'].sum())}/{n + n_staged} keyframes="
        f"{out['n_keyframes']} loops={out['n_loops_closed']} inserted at "
        f"{np.nonzero(out['stats'][:n, 6])[0].tolist()} median t err "
        f"{t_med:.5f} m, rot err {r_med:.4f} deg; features with depth on "
        f"frame 0: {n_depth0}")
    log(f"{label}: build pass {build[0]:.3f} ms/frame (CUDA events), "
        f"{build[1]:.3f} (host clock)")
    log(f"{label}: front end by stage, ms per frame over {n_staged} frames "
        f"(synced; nested stages count in their callers): "
        f"{ {k: round(v / n_staged, 3) for k, v in staged.items()} }")
    log(f"{label}: launches in the build pass {first_launches}, by the "
        f"stereo association per frame {sorted(set(match_launches))}")
    assert out["initialized"] and out["lost_at"] == -1, "tracking lost"
    assert out["valid"].all(), "not every frame valid"
    assert match_launches == [1] * n, \
        "the stereo association is not one masked_best_two launch per frame"
    assert first_launches["pose_lm"] >= 2 * (n - 1), \
        "fewer than two pose LM launches per tracked frame"
    return first_launches, out, tracker, (t_med, n_depth0), problems


def stereo_bench_setup():
    """bench.py's stereo figure: (config, rectified pairs, poses)."""
    cfg = TrackerConfig(
        sensor="stereo", n_features=1000, min_init_features=200,
        map_cfg=BENCH_MAP, fps=30)
    assert cfg.bf == 40.0 and cfg.fx == 500.0
    pairs = list(zip((img for img, _ in frames_of("orbit60")),
                     frames_of("orbit60_right")))
    return cfg, pairs, orbit_trajectory(n_frames=60)


def stereo_kitti_setup():
    """bench.py's KITTI-shape stereo figure: (config, pairs, poses)."""
    cfg = TrackerConfig(
        sensor="stereo", n_features=2000, min_init_features=200,
        bf=bench.KITTI_BF, map_cfg=MapConfig(k_max=24, n_feat=2000,
                                             l_max=8000, d_max=8),
        fps=10, **bench.KITTI_CAM)
    pairs = list(zip(frames_of("kitti30_left"), frames_of("kitti30_right")))
    return cfg, pairs, orbit_trajectory(n_frames=60)[:30]


def run_stereo_bench(dev, rgbd_build_launches):
    """Phase 9: stereo at the bench configuration."""
    cfg, pairs, poses = stereo_bench_setup()
    launches, out, _, (t_med, n_depth0), problems = run_stereo(
        dev, "stereo (bench)", cfg, pairs, poses)
    assert out["n_keyframes"] >= 3, out["n_keyframes"]
    assert t_med < 0.03, "pose error gate (tests/test_auto.py:183-185)"
    assert n_depth0 > 200, "too few features with depth on frame 0"
    assert not missing(launches, stereo=True), \
        f"kernels {missing(launches, True)} never launched on the stereo path"
    more = launches["masked_best_two"] - rgbd_build_launches["masked_best_two"]
    log(f"stereo (bench): {more} more masked_best_two launches than the "
        f"default RGB-D tracker over the same {len(pairs)} poses")
    assert more >= len(pairs), \
        "fewer than one masked_best_two launch per frame more than RGB-D"
    return launches, problems


def run_stereo_kitti(dev):
    """Phase 10: stereo at the KITTI 00-02 camera."""
    cfg, pairs, poses = stereo_kitti_setup()
    launches, out, tracker, _, problems = run_stereo(
        dev, "stereo (KITTI camera)", cfg, pairs, poses)
    lines = tracker.trajectory_kitti()
    log(f"stereo (KITTI camera): trajectory_kitti() gives {len(lines)} "
        f"lines of {len(lines[0].split())} numbers")
    assert len(lines) == int(out["valid"].sum()) == out["n_frames"]
    return launches, problems


MONO_MAP = MapConfig(k_max=24, n_feat=2000, l_max=8000, d_max=8)
MONO_STAGES = ((msearch, "search_for_initialization"),
               (initializer, "sample_octets"),
               (initializer, "initialize_from_samples"),
               (steps, "insert_keyframe"),
               (steps, "insert_landmarks_two_view"),
               (steps, "refresh_landmarks"),
               (steps, "local_bundle_adjustment"),
               (steps, "scene_median_depth"), (steps, "scale_map"),
               (auto_loop, "add_keyframe_bow"))


def mono_bench_cfg():
    """bench.py's monocular figure (bench.py:202-206)."""
    return TrackerConfig(sensor="mono", n_features=2000,
                         min_init_features=200, min_init_matches=60,
                         map_cfg=MONO_MAP, fps=30)


@contextlib.contextmanager
def counted_launches(*targets):
    """Within the block, each (module, function name) of ``targets`` adds
    the masked_best_two launches of its calls to the yielded dict."""
    out = {name: 0 for _, name in targets}

    def counted(name, fn):
        def run(*a, **kw):
            before = hamming.LAUNCHES["masked_best_two"]
            r = fn(*a, **kw)
            out[name] += hamming.LAUNCHES["masked_best_two"] - before
            return r
        return run

    saved = [getattr(mod, name) for mod, name in targets]
    try:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, counted(name, fn))
        yield out
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


# the pose LM's callers that only pass a solve on: a captured problem is
# named after the function that called them
POSE_RELAYS = ("_pose_optimize_from_matches", "pose_optimize_one")
# and the match tail's
TAIL_RELAYS = ("windowed_match",)


@contextlib.contextmanager
def captured_problems():
    """Within the block, every launch of a kernel wrapper leaves a copy of
    its inputs in the yielded dict, the newest of each (kernel, calling
    function, shape): the problems this path really gives the kernels, to
    be held against the plain versions after the run. The pose LM's shape
    is (B, N), its calling function the first outside POSE_RELAYS, and its
    inputs (cam, R0, t0, Xw, obs_uvr, inv_sigma2, valid); the dense BA's
    ("ba") shape is (P, L, iterations) and its inputs (cam, problem,
    iterations, robust, initial damping, accept_all); the match tail's
    ("match_tail", K7) shape is (Q, N), its calling function the first
    outside TAIL_RELAYS, and its inputs (the positional arguments, the
    keyword ones)."""
    out = {}
    saved = hamming.masked_best_two, hamming.distance_matrix
    saved_pose = pose_opt.optimize_pose
    saved_ba = ba.ba_solve
    saved_tail = mcore.match_tail

    def keep(kernel, fn):
        def run(*tensors):
            if tensors[0].is_cuda and tensors[0].shape[0]:
                caller = sys._getframe(1).f_code.co_name
                shape = (tensors[0].shape[0], tensors[1].shape[0])
                out[kernel, caller, shape] = tuple(t.clone() for t in tensors)
            return fn(*tensors)
        return run

    def keep_pose(cam, *tensors, **kw):
        if tensors[0].is_cuda and tensors[0].shape[0] and not kw:
            frame = sys._getframe(1)
            while frame.f_code.co_name in POSE_RELAYS:
                frame = frame.f_back
            out["pose_lm", frame.f_code.co_name,
                tuple(tensors[-1].shape)] = (cam, *(t.clone()
                                                    for t in tensors))
        return saved_pose(cam, *tensors, **kw)

    def keep_ba(cam, prob, iters=10, robust=True, init_lambda=1e-4,
                accept_all=False):
        if prob.X.is_cuda and iters:
            caller = sys._getframe(1).f_code.co_name
            lam = (init_lambda.clone() if isinstance(init_lambda, torch.Tensor)
                   else init_lambda)
            out["ba", caller, (prob.R.shape[0], prob.X.shape[0], iters)] = (
                cam, ba.BAProblem(*(t.clone() for t in prob)), iters, robust,
                lam, accept_all)
        return saved_ba(cam, prob, iters, robust, init_lambda, accept_all)

    def keep_tail(best, *a, **kw):
        if best.is_cuda and best.shape[0]:
            frame = sys._getframe(1)
            while frame.f_code.co_name in TAIL_RELAYS:
                frame = frame.f_back

            def clone(v):
                return v.clone() if isinstance(v, torch.Tensor) else v
            out["match_tail", frame.f_code.co_name, (best.shape[0], a[3])] = (
                tuple(clone(v) for v in (best, *a)),
                {k: clone(v) for k, v in kw.items()})
        return saved_tail(best, *a, **kw)

    hamming.masked_best_two = keep("masked_best_two", saved[0])
    hamming.distance_matrix = keep("distance_matrix", saved[1])
    pose_opt.optimize_pose = keep_pose
    ba.ba_solve = keep_ba
    mcore.match_tail = keep_tail
    try:
        yield out
    finally:
        hamming.masked_best_two, hamming.distance_matrix = saved
        pose_opt.optimize_pose = saved_pose
        ba.ba_solve = saved_ba
        mcore.match_tail = saved_tail


def run_mono(dev):
    """Phase 11: the monocular tracker at the bench configuration, the
    default AutoTrackerConfig(), over the 60-frame orbit (the bench's mono
    figure times the re-tracking passes). Returns (the pass's launches,
    the tracker, the newest problem of each shape it gave the kernels)."""
    n = 60
    poses = sequences()[MONO_SEQ][1]
    frames = [f[0] if isinstance(f, tuple) else f
              for f in frames_of(MONO_SEQ)]
    tracker = AutoTracker(mono_bench_cfg(), AutoTrackerConfig(
        traj_capacity=8 * n), device=dev)
    assert tracker._step.maint_phases[0] == tracker._step.ph_loop
    reset_launches()
    boot, build_ms = {}, []
    first_init = initializer.initialize_from_samples

    def watched_init(*a, **kw):
        res = first_init(*a, **kw)
        boot["tries"] = boot.get("tries", 0) + 1
        boot["used_h"], boot["success"] = bool(res.used_h), bool(res.success)
        return res

    initializer.initialize_from_samples = watched_init
    try:
        with captured_problems() as problems:
            with counted_launches(
                    (msearch, "search_for_initialization"),
                    (msearch, "search_for_triangulation")) as by_fn:
                for i, img in enumerate(frames):
                    was = tracker.state.initialized
                    with stage_ms(*(() if was else MONO_STAGES)) as staged:
                        build_ms.append(synced_ms(
                            lambda: tracker.process_mono(img)))
                    if tracker.state.initialized and not was:
                        m = tracker.state.map
                        boot.update(
                            frame=i, ms=build_ms[-1], stages=dict(staged),
                            n_lm=int(m.n_lm),
                            depth0=float(steps.scene_median_depth(m, 0)))
    finally:
        initializer.initialize_from_samples = first_init
    launches = launch_counts()
    out = tracker.finalize()
    assert out["initialized"] and "frame" in boot, "never bootstrapped"
    b = boot["frame"]
    tracked = [v for i, v in enumerate(build_ms) if i > b]
    log(f"mono (bench): bootstrap at frame {b} after {boot['tries']} tries "
        f"of the initializer, {'H' if boot['used_h'] else 'F'} won, "
        f"{boot['n_lm']} two-view landmarks, median scene depth of keyframe "
        f"0 {boot['depth0']:.6f}; the bootstrap frame took {boot['ms']:.2f} "
        f"ms (the frames before it "
        f"{[round(v, 2) for v in build_ms[:b]]}), by stage (ms, synced): "
        f"{boot['stages']}")
    log(f"mono (bench): initialized={out['initialized']} "
        f"lost_at={out['lost_at']} valid={int(out['valid'].sum())}/{n} "
        f"keyframes={out['n_keyframes']} loops={out['n_loops_closed']} "
        f"inserted at {np.nonzero(out['stats'][:n, 6] == 1)[0].tolist()}")
    log(f"mono (bench): build pass {np.mean(tracked):.3f} ms/frame after the "
        f"bootstrap (host clock, synced per frame; median "
        f"{np.median(tracked):.3f})")
    log(f"mono (bench): launches {launches}, of masked_best_two by function "
        f"{by_fn}")
    assert out["lost_at"] == -1, "tracking lost"
    assert out["valid"][b:].all(), \
        "a frame after the bootstrap frame is invalid"
    assert not out["valid"][:b].any()
    assert out["n_keyframes"] >= 3, out["n_keyframes"]
    assert abs(boot["depth0"] - 1.0) < 1e-3, "the gauge is not depth 1"
    rmse = bench.sim_ate(out, poses)
    log(f"mono (bench): similarity-aligned ATE {rmse:.5f} m")
    assert rmse < 0.03, "ATE gate (tests/test_auto.py:310-311)"
    assert by_fn["search_for_initialization"] > 0
    assert by_fn["search_for_triangulation"] > 0
    return launches, tracker, problems


def mono_first_two(dev):
    """The monocular feature sets of the first two frames of the mono
    sequence, at the bench configuration's 2000 features."""
    ext = OrbExtractor(n_features=2000)
    out = []
    for f in first_frames(MONO_SEQ, 2):
        img = f[0] if isinstance(f, tuple) else f
        f = ext(torch.as_tensor(img, device=dev))
        out.append(msearch.FeatureSet(f.xy, torch.full_like(f.angle, -1.0),
                                      f.octave, f.angle, f.desc, f.valid))
    return out


def compare_initializer(dev):
    """The two-view initializer on the card and on the CPU from the same
    matches and the same 8-point sets (drawn on the CPU): the batched
    eigh and svd go through cuSOLVER on the card and LAPACK on the host,
    and the two may rank the hypotheses differently. Gated on the
    outcome, not on the winner's index: both succeed or both fail; where
    they succeed (with the same model or one with H and one with F), nine
    tenths of the good points are shared, the rotations agree within 1e-2
    and the translation directions within 10 degrees (frames 0 and 1 are
    a low-parallax pair, won by H, whose translation is the least
    determined part: the two differ by some 5 degrees)."""
    f1, f2 = mono_first_two(dev)
    idx, _, matched = msearch.search_for_initialization(f1, f2, f1.xy)
    p2 = f2.xy[idx.clamp(min=0).long()]
    cfg = mono_bench_cfg()
    K4 = (cfg.cam.fx, cfg.cam.fy, cfg.cam.cx, cfg.cam.cy)
    gen = torch.Generator().manual_seed(auto_loop.SEED)
    octets = initializer.sample_octets(gen, matched.cpu())
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        res[name] = initializer.initialize_from_samples(
            octets.to(d), K4, f1.xy.to(d), p2.to(d), matched.to(d))
    c, h = res["card"], res["cpu"]
    dR = float((c.R.cpu() - h.R).abs().max())
    cos = torch.dot(c.t.cpu(), h.t) / (c.t.norm().cpu() * h.t.norm()).clamp(
        min=1e-12)
    dt = float(torch.rad2deg(torch.acos(cos.clamp(-1.0, 1.0))))
    shared = int((c.good.cpu() & h.good).sum())
    log(f"initializer card vs cpu (frames 0 and 1, {int(matched.sum())} "
        f"matches, the same 200 8-point sets): success {bool(c.success)} vs "
        f"{bool(h.success)}, {'H' if c.used_h else 'F'} vs "
        f"{'H' if h.used_h else 'F'}, good points {int(c.good.sum())} vs "
        f"{int(h.good.sum())}, of them shared {shared}, max |R| diff "
        f"{dR:.2e}, translation directions {dt:.2f} degrees apart")
    assert torch.isfinite(c.R).all() and torch.isfinite(c.t).all()
    assert bool(c.success) == bool(h.success), "card and CPU disagree"
    if bool(c.success):
        assert shared >= 0.9 * max(int(c.good.sum()), int(h.good.sum()))
        assert dR < 1e-2 and dt < 10.0, "another pose from the same sets"


def check_mono_problems(dev, tracker, problems, rows):
    """Phase 3's problems that need the monocular run, held bit-exact
    against the plain versions and the baseline kernel and timed like the
    others: the epipolar mask of the run's keyframes 1 and 0 at
    [2000, 2000], and the newest problem of every (calling function,
    shape) that phase 11 and the bench's mono figure (phase 17) gave the
    kernels, the local-map search at [4096, 2000] among them. Appended to
    the kernels' rows."""
    m = tracker.state.map
    k1, k2 = steps._kf_featureset(m, 1), steps._kf_featureset(m, 0)
    F12, e2 = steps.epipolar_geometry(m, tracker.cfg.cam, 1, 0)
    todo = [("epipolar [2000,2000]", "masked_best_two",
             (k1.desc, k2.desc, msearch.triangulation_mask(
                 k1, k2, m.kf_lm[1] < 0, m.kf_lm[0] < 0, F12, e2)))]
    assert todo[0][2][2].shape == (2000, 2000)
    shapes = {(kernel, shape) for kernel, _, shape in problems}
    assert ("masked_best_two", (4096, 2000)) in shapes, sorted(shapes)
    assert ("masked_best_two", (2000, 2000)) in shapes, sorted(shapes)
    hold_problems(todo + captured_todo("mono path", problems), rows)


def captured_todo(label, problems):
    """captured_problems' dict as (where, kernel, tensors) rows."""
    return [(f"{label}, {caller} [{','.join(map(str, shape))}]", kernel,
             tensors)
            for (kernel, caller, shape), tensors in sorted(
                problems.items(), key=lambda kv: kv[0])]


def hold_problems(todo, rows):
    """Each (where, kernel, tensors) of ``todo`` held bit-exact against the
    plain version and the baseline kernel, then timed with its bound; the
    rows join the kernels' ``other_problems``."""
    base = BaselineKernels()
    popc_rate = popc_per_s()
    k4 = next(r for r in rows if r["name"] == "ba_solve")
    for where, kernel, tensors in todo:
        if kernel == "ba":
            # PR 13's kernels and the tensor-core candidate are timed in
            # phase 3
            row, err = hold_ba(where, tensors, plain_reps=1,
                               time_baseline=False)
            k4["other_problems"].append(row)
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            continue
        if kernel == "pose_lm":
            # the baseline kernel is held to the gates, timed in phase 3
            row, err = hold_pose(where, tensors, plain_reps=1,
                                 time_baseline=False)
            rows[2]["other_problems"].append(row)
            rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], err)
            continue
        if kernel == "match_tail":
            hold_tail(where, tensors, rows)
            continue
        tensors = tuple(t.contiguous() for t in tensors)
        if kernel == "distance_matrix":
            d1, d2 = tensors
            want = hamming.distance_matrix_plain(d1, d2)
            assert torch.equal(hamming.distance_matrix(d1, d2), want), where
            assert torch.equal(base.distance_matrix(d1, d2), want), where
            log(f"kernel check {where}: distance_matrix bit-exact")
            row = time_pair(lambda: hamming.distance_matrix(d1, d2),
                            lambda: base.distance_matrix(d1, d2),
                            lambda: hamming.distance_matrix_plain(d1, d2))
            row["bound_ms"], row["bound_by"] = bound_distance_matrix(
                d1.shape[0], d2.shape[0], popc_rate)
            row["problem"] = where
            rows[1]["other_problems"].append(row)
            log(f"distance_matrix {where}: " + fmt_times(row))
            continue
        dq, dt, mask = tensors
        want = hamming.masked_best_two_plain(dq, dt, mask)
        assert_same("masked_best_two", hamming.masked_best_two(dq, dt, mask),
                    want, where)
        assert_same("baseline masked_best_two",
                    base.masked_best_two(dq, dt, mask), want, where)
        share = float(mask.float().mean())
        log(f"kernel check {where}: masked_best_two bit-exact "
            f"({share:.4f} admissible)")
        row = time_pair(lambda: hamming.masked_best_two(dq, dt, mask),
                        lambda: base.masked_best_two(dq, dt, mask),
                        lambda: hamming.masked_best_two_plain(dq, dt, mask))
        row["bound_ms"], row["bound_by"] = bound_best_two(dq, dt, mask,
                                                          popc_rate)
        row["problem"], row["admissible"] = where, share
        rows[0]["other_problems"].append(row)
        log(f"masked_best_two {where}: " + fmt_times(row))


def bound_tail(args, kw) -> tuple:
    """K7's bytes, each once: K1's four [Q] outputs and whichever of
    angle_q and values [Q], octave_t, angle_t and frame_lm [N] the call
    passes read, the [Q] flags and, with values, the new map [N] written
    (the per-target tables stay in shared memory up to TAIL_SHARED
    targets)."""
    q, n = args[0].shape[0], args[4]
    n_bytes = 16 * q + q + sum(4 * v.numel() for v in kw.values()
                               if isinstance(v, torch.Tensor))
    if kw.get("values") is not None:
        n_bytes += 4 * n
    return bound(n_bytes, 0, 1.0)


def run_tail(fn, args, kw):
    """fn (match_tail or its plain version) on a captured call, the map
    written into a fresh ``out`` where the call passes values: (idx, best,
    matched), and the map last where there is one."""
    if kw.get("values") is None:
        return tuple(fn(*args, **kw))
    out = torch.empty(args[4], dtype=torch.int32, device=args[0].device)
    return tuple(fn(*args, **kw, out=out)) + (out,)


def hold_tail(where: str, call, rows):
    """One captured match tail (K7) held in bits against its plain version
    on the card (the chain it replaced) and on the CPU, then timed: per
    call with CUDA events, on the device inside a replayed CUDA graph, and
    the plain version per call on the card. The rows join K7's row, made
    from the first problem held."""
    args, kw = call
    kw = {k: v for k, v in kw.items() if k != "out"}
    got = run_tail(mcore.match_tail, args, kw)
    for want in (run_tail(mcore.match_tail_plain, args, kw),
                 run_tail(mcore.match_tail_plain, tuple(
                     a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in args), {
                     k: v.cpu() if isinstance(v, torch.Tensor) else v
                     for k, v in kw.items()})):
        assert len(got) == len(want), where
        for part, a, b in zip(("idx", "best", "matched", "frame_lm"), got,
                              want):
            assert torch.equal(a.cpu(), b.cpu()), \
                f"match_tail {part} differs at {where}"
    row = {"ms": cuda_ms(lambda: run_tail(mcore.match_tail, args, kw), 50),
           "device_ms": graph_ms(lambda: run_tail(mcore.match_tail, args,
                                                  kw)),
           "plain_ms": cuda_ms(lambda: run_tail(mcore.match_tail_plain, args,
                                                kw), 5),
           "problem": where, "matched": int(got[2].sum())}
    row["bound_ms"], row["bound_by"] = bound_tail(args, kw)
    log(f"kernel check {where}: match_tail bit-exact ({row['matched']} "
        f"matched); K7 {row['ms']:.4f} ms per call, {row['device_ms']:.4f} "
        f"ms on the device; plain {row['plain_ms']:.4f}; bound "
        f"{row['bound_ms']:.6f} ms by bytes")
    k7 = next((r for r in rows if r["name"] == "hamming_match_tail"), None)
    if k7 is None:
        rows.append(dict(
            row, name="hamming_match_tail", route="cuda",
            source="orb_slam2_with_comment_tpu_torch/csrc/hamming.cu",
            replaces="orb_slam2_with_comment_tpu/matching/core.py:41-70, "
                     "called from windowed_match :87 (XLA ops, no Pallas "
                     "kernel)", baseline=None,
            max_abs_err=0, library_ms=None, other_problems=[]))
    else:
        k7["other_problems"].append(row)


# ---------------------------------------------------------------------------
# phase 13: the System facade and the host-driven Tracker
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counted_syncs():
    """Within the block, box["n"] counts the host's waits on the card: the
    synchronizing CUDA calls that torch.cuda's sync debug mode flags
    (item(), .cpu(), a boolean mask index, ...) and the waits on a
    non-blocking readback's event; box["readback"] counts the latter
    alone."""
    box = {"n": 0, "readback": 0}
    wait = loop_closing.Readback.result

    def counted(self):  # one wait per readback: its first result()
        first = self._event is not None and not hasattr(self, "_waited")
        box["readback"] += first
        self._waited = True
        return wait(self)

    loop_closing.Readback.result = counted
    on_card = torch.cuda.is_available()
    if on_card:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield box
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(mode)
        loop_closing.Readback.result = wait
    box["n"] = box["readback"] + sum("synchroniz" in str(w.message)
                                    for w in caught)


def run_system_rgbd(dev):
    """Phase 13a: System(cfg, Sensor.RGBD) at the bench configuration with
    the default pipelining: the 60-frame orbit, 3 black frames, frames 2-4
    again, then frames 5-7 in localization mode; the three trajectory
    files; a session saved and loaded into a fresh System that tracks the
    next frame. Returns (launches, the newest problem of each shape the
    run gave the kernels)."""
    n = 60
    poses = orbit_trajectory(n_frames=n)
    frames = frames_of("orbit60")
    black = (np.zeros((480, 640), np.uint8), np.zeros((480, 640), np.uint16))
    seq = frames + [black] * 3 + frames[2:5]
    r0 = n + 3  # the first revisit frame
    slam = System(bench_cfg(), Sensor.RGBD, device=dev)
    tr = slam.tracker
    reset_launches()
    rows = []  # (ms, syncs, K1 launches, inserted, state before, pose)
    with captured_problems() as problems:
        for i, (img, depth) in enumerate(seq):
            n_kf, state = tr.n_kf_host, tr.state
            k1 = k1_launches(hamming.LAUNCHES)
            box = {}

            def call():
                with counted_syncs() as c:
                    box["pose"] = slam.track_rgbd(img, depth, i / 30.0)
                box["syncs"] = c

            ms = synced_ms(call)
            rows.append((ms, box["syncs"]["n"],
                         k1_launches(hamming.LAUNCHES) - k1,
                         tr.n_kf_host > n_kf, state, box["pose"],
                         tr.last_reloc_frame, box["syncs"]["readback"]))
        launches = launch_counts()
        n_kf_loc = tr.n_kf_host
        slam.activate_localization_mode()
        for i, (img, depth) in enumerate(frames[5:8]):
            slam.track_rgbd(img, depth, (len(seq) + i) / 30.0)
        loc_kf = [tr.n_kf_host]
        chain = slam._chain_poses()  # flushes the frames in flight
        loc_kf.append(tr.n_kf_host)
        slam.deactivate_localization_mode()
    ms = np.array([r[0] for r in rows])
    ins = np.array([r[3] for r in rows])
    lost = [i for i, r in enumerate(rows) if r[4] == TrackState.LOST]
    reloc = [i for i, r in enumerate(rows) if r[6] == i]
    logged = {rec[0] for rec in tr.rel_log}
    frame_of = [rec[0] for rec in tr.rel_log]
    assert len(chain) == len(frame_of)
    t_err = [np.linalg.norm(tcw - poses[f][1])
             for (_, _, tcw), f in zip(chain, frame_of) if f < n]
    r_err = [np.degrees(np.arccos(np.clip((np.trace(Rcw @ poses[f][0].T) - 1)
                                          / 2, -1, 1)))
             for (_, Rcw, _), f in zip(chain, frame_of) if f < n]
    log(f"system rgbd: inserts at calls {np.nonzero(ins)[0].tolist()}, "
        f"{tr.n_kf_host} keyframes, maps K={tr.map.kf_R.shape[0]} "
        f"L={tr.map.lm_pw.shape[0]}; calls made while LOST {lost}, "
        f"relocalized at {reloc}; median t err {np.median(t_err):.5f} m, "
        f"rot err {np.median(r_err):.4f} deg over {len(t_err)} orbit frames")
    log(f"system rgbd: ms per frame (host clock, synced per frame): orbit "
        f"{ms[:n].mean():.2f} (median {np.median(ms[:n]):.2f}), insert "
        f"calls {ms[:n][ins[:n]].mean():.2f} (n={int(ins[:n].sum())}), "
        f"other calls {ms[:n][~ins[:n]].mean():.2f}; relocalization frame "
        f"{ms[reloc[0]]:.2f}" if reloc else "system rgbd: no relocalization")
    log(f"system rgbd: syncs per frame {np.mean([r[1] for r in rows]):.2f} "
        f"(orbit insert calls {np.mean([r[1] for r in rows[:n] if r[3]]):.2f}"
        f", other orbit calls "
        f"{np.mean([r[1] for r in rows[:n] if not r[3]]):.2f}, "
        f"relocalization frame {rows[reloc[0]][1] if reloc else None}; of "
        f"them waits on the tracker's own non-blocking readbacks "
        f"{np.mean([r[7] for r in rows]):.2f}); K1 "
        f"launches per frame {np.mean([r[2] for r in rows]):.2f} "
        f"({launches} in {len(rows)} frames)")
    assert tr.state == TrackState.OK and rows[0][5] is not None, \
        "not initialized"
    assert all(r[5] is not None for r in rows[:n]), "an orbit frame failed"
    assert np.median(t_err) < 0.02 and np.median(r_err) < 1.0, \
        "pose error gate"
    assert not logged & set(range(n, r0)), "a black frame was tracked"
    assert lost and lost[0] < r0 + 2, "the black frames did not go LOST"
    first_lost_revisit = min(i for i in lost if i >= r0)
    assert reloc and reloc[0] == first_lost_revisit, \
        "did not relocalize at the first revisit frame processed while lost"
    T = np.asarray(rows[reloc[0]][5])
    reloc_err = float(np.linalg.norm(T[:3, 3] - poses[2 + reloc[0] - r0][1]))
    log(f"system rgbd: relocalized pose error {reloc_err:.5f} m; "
        f"localization mode: keyframes {n_kf_loc} -> {loc_kf}")
    assert reloc_err < 0.05, "relocalized pose error"
    assert loc_kf == [n_kf_loc] * 2, "localization mode inserted a keyframe"
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for fn in ("save_trajectory_tum", "save_keyframe_trajectory_tum",
                   "save_trajectory_kitti"):
            path = os.path.join(tmp, fn + ".txt")
            getattr(slam, fn)(path)
            with open(path) as f:
                files[fn] = f.read().splitlines()
        log(f"system rgbd: trajectory files {[len(v) for v in files.values()]}"
            f" lines; rel_log {len(tr.rel_log)}, keyframes {tr.n_kf_host}")
        assert len(files["save_trajectory_tum"]) == len(tr.rel_log)
        assert len(files["save_keyframe_trajectory_tum"]) == tr.n_kf_host
        assert all(len(ln.split()) == 12
                   for ln in files["save_trajectory_kitti"])
        path = os.path.join(tmp, "session.npz")
        checkpoint.save_session(path, tr)
        fresh = System(bench_cfg(), Sensor.RGBD, device=dev)
        checkpoint.load_session(path, fresh.tracker)
    f_next = fresh.tracker.frame_count
    pose = fresh.track_rgbd(*frames[8], f_next / 30.0)
    fresh.tracker.flush()
    err = float(np.linalg.norm(np.asarray(pose)[:3, 3] - poses[8][1]))
    log(f"system rgbd: session reloaded, frame {f_next} tracked: "
        f"{fresh.tracker.rel_log[-1][0] == f_next}, error {err:.5f} m")
    assert pose is not None and fresh.get_tracking_state() == TrackState.OK
    assert fresh.tracker.rel_log[-1][0] == f_next and err < 0.05
    assert not missing(launches), \
        f"kernels {missing(launches)} never launched on the System path"
    return launches, problems


def mean_chi2(m, cam) -> float:
    """Mean weighted reprojection chi2 (u, v) over all live observations."""
    ok = (m.lm_obs_kf >= 0) & m.lm_valid[:, None]
    kf = m.lm_obs_kf.clamp(min=0).long()
    ft = m.lm_obs_feat.long()
    Xc = torch.einsum("ldij,lj->ldi", m.kf_R[kf], m.lm_pw) + m.kf_t[kf]
    z = torch.where(Xc[..., 2].abs() < 1e-9, 1e-9, Xc[..., 2])
    e2 = ((m.kf_xy[kf, ft][..., 0] - (cam.fx * Xc[..., 0] / z + cam.cx)) ** 2
          + (m.kf_xy[kf, ft][..., 1] - (cam.fy * Xc[..., 1] / z + cam.cy))
          ** 2)
    w = msearch.inv_sigma2_at(m.kf_octave[kf, ft])
    return float(torch.where(ok, e2 * w, 0.0).sum() / ok.sum().clamp(min=1))


def welded_count(m, early=4, late=13) -> int:
    """Landmarks observed on both sides of the loop."""
    obs = m.lm_obs_kf.cpu().numpy()
    valid = m.lm_valid.cpu().numpy()
    return int((((obs >= 0) & (obs <= early)).any(1)
                & (obs >= late).any(1) & valid).sum())


HOST_LOOP_STAGES = ((LoopCloser, "detect"), (LoopCloser, "compute_sim3"),
                    (LoopCloser, "correct"), (LoopCloser, "_essential_graph"),
                    (LoopCloser, "_global_ba"))


def run_host_loop(dev):
    """Phase 13b: tests/test_loop_host.py's controlled loop at full width
    through keyframe_step, KeyFrameDatabase.add and LoopCloser.process
    (min_gap=1), then one chunked global BA."""
    cfg = TrackerConfig(n_features=1000, min_init_features=200,
                        map_cfg=LOOP_MAP, fps=30, depth_factor=1.0)
    poses = sequences()["loop18"][1]
    rendered = frames_of("loop18")
    ext = OrbExtractor(n_features=1000)
    cam = cfg.cam
    th_depth = float(np.float32(cfg.depth_threshold))
    W, H = cfg.width, cfg.height
    auto_loop.warm_up_autodiff()
    db = KeyFrameDatabase(V.load_default_vocabulary(dev), LOOP_MAP.k_max)
    closer = LoopCloser(cam, db, fix_scale=True, min_gap=1, width=W,
                        height=H)
    m = empty_map(cfg.map_cfg, dev)
    drift = np.zeros(3, np.float32)
    drift_step = np.float32([0.015, 0.0, 0.008])
    events, before, fire = [], None, None
    reset_launches()
    for k, (R, t) in enumerate(poses):
        img, depth = rendered[k]
        feats, d = steps.extract_rgbd_features(
            ext, cam, torch.as_tensor(np.clip(img, 0, 255).astype(
                np.float32), device=dev),
            torch.as_tensor(depth, device=dev), 1.0, W, H)
        if 8 <= k < 14:
            drift = drift + drift_step
        obs = steps.FrameObs(feats, d, torch.full(
            (d.shape[0],), -1, dtype=torch.int32, device=dev))
        m = steps.keyframe_step(m, cam, obs, torch.as_tensor(R, device=dev),
                                torch.as_tensor(t + drift, device=dev), k,
                                th_depth, W, H)
        db.add(k, feats.desc, feats.valid)
        n_before = closer.n_loops_closed
        if before is None:
            now = (welded_count(m), mean_chi2(m, cam))
        box = {}
        with stage_ms(*HOST_LOOP_STAGES) as staged:
            ms = synced_ms(lambda: box.setdefault("m", closer.process(m, k)))
        m = box["m"]
        if closer.n_loops_closed > n_before:
            events.append(k)
            if before is None:
                before, fire = now, (k, ms, dict(staged))
    launches = launch_counts()
    assert events, "no loop closed over the revisit"
    gt = np.stack([-(R.T @ t) for R, t in poses])
    kf_R, kf_t = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
    est = np.stack([-(kf_R[k].T @ kf_t[k]) for k in range(len(poses))])
    drifted, dr = [], np.zeros(3, np.float32)
    for k, (R, t) in enumerate(poses):
        if 8 <= k < 14:
            dr = dr + drift_step
        drifted.append(-(R.T @ (t + dr)))
    ate_drifted = ate_rmse(np.stack(drifted), gt)
    ate_final = ate_rmse(est, gt)
    welded, chi2 = welded_count(m), mean_chi2(m, cam)
    log(f"host loop: fired at keyframes {events}; aligned keyframe ATE "
        f"{ate_drifted:.5f} -> {ate_final:.5f} m; welded landmarks "
        f"{before[0]} -> {welded}; mean chi2 {before[1]:.4f} -> {chi2:.4f}; "
        f"launches {launches}")
    log(f"host loop: the firing process() at keyframe {fire[0]} took "
        f"{fire[1]:.2f} ms (host clock, synced), by stage (ms, synced, "
        f"nested stages count in their callers): {fire[2]}")
    assert events[0] >= 10
    assert ate_drifted > 0.02 and ate_final < 0.35 * ate_drifted, \
        "loop correction did not reduce drift"
    assert welded > before[0] and welded >= 30, "too few welded landmarks"
    assert chi2 < before[1], "the mean chi2 did not drop"
    assert torch.isfinite(m.kf_t).all() and torch.isfinite(m.lm_pw).all()
    # the chunked global BA, once, then a newer start mid-run
    closer._start_gba(m)
    polls, out, chunk_ms = 0, None, []
    while out is None and polls < 20:
        box = {}
        chunk_ms.append(synced_ms(lambda: box.setdefault(
            "o", closer.poll_gba(m))))
        out = box["o"]
        polls += 1
    gen = closer.gba_generation
    closer._start_gba(m)
    closer.poll_gba(m)
    closer._start_gba(m)
    log(f"host loop: chunked GBA done in {polls} polls, ms per poll "
        f"{[round(v, 2) for v in chunk_ms]}; restarts bump the generation "
        f"{gen} -> {closer.gba_generation}")
    assert polls == -(-closer.gba_total_iters // closer.gba_chunk_iters)
    assert closer.gba_generation == gen + 2
    assert closer._gba["left"] == closer.gba_total_iters
    assert torch.isfinite(out.kf_t).all()
    for name in hamming.LAUNCHES:  # given poses: no pose LM here
        assert launches[name] > 0, \
            f"kernel {name} never launched on the host loop"
    return launches


def run_lifecycle(dev):
    """Phase 13c: tests/test_lifecycle.py's tiny-capacity run at 640x480:
    800 features, MapConfig(12, 800, 2500, 8), fps 10, the 60-frame orbit
    through the host Tracker. Returns (launches, the newest problem of
    each shape it gave the kernels)."""
    poses = orbit_trajectory(n_frames=60)
    cfg = TrackerConfig(n_features=800, min_init_features=150,
                        map_cfg=MapConfig(12, 800, 2500, 8), fps=10,
                        depth_factor=1.0 / 5000.0)
    tracker = Tracker(cfg, device=dev)
    reset_launches()
    with captured_problems() as problems:
        t0 = time.perf_counter()
        got = [tracker.process_rgbd(img, depth, frame_id=k) is not None
               for k, (img, depth) in enumerate(frames_of("orbit60"))]
        tracker.flush()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    K, L = tracker.map.kf_R.shape[0], tracker.map.lm_pw.shape[0]
    ids, Rs, ts = tracker.trajectory_arrays()
    rmse = ate_rmse(camera_centers(Rs, ts), camera_centers(
        np.stack([poses[i][0] for i in ids]),
        np.stack([poses[i][1] for i in ids])))
    slam = System.__new__(System)
    slam.tracker = tracker
    chain = slam._chain_poses()
    log(f"lifecycle: K 12 -> {K}, L 2500 -> {L}, archived keyframes "
        f"{len(tracker.kf_archive)}, {tracker.n_kf_host} live keyframes, "
        f"tracked {sum(got)}/{len(got)}, ATE {rmse:.5f} m, chain "
        f"{len(chain)} of {len(tracker.rel_log)} rows, "
        f"{1000 * wall / len(got):.2f} ms/frame (host clock); launches "
        f"{launches}; K1 shapes "
        f"{sorted({(k, s) for k, _, s in problems})}")
    assert K > 12 or L > 2500 or tracker.kf_archive, "no growth, no compaction"
    assert all(got), "a frame did not track"
    assert rmse < 0.05, "ATE gate (tests/test_lifecycle.py)"
    assert len(chain) == len(tracker.rel_log), "a rel_log row did not resolve"
    return launches, problems


# ---------------------------------------------------------------------------
# phase 14: the real-sequence path: fixtures, PNG decode and the drivers
# ---------------------------------------------------------------------------

FIXTURE_FRAMES = {"tum_fixture": 60, "kitti_fixture": 30, "euroc_fixture": 30}
# the working directory of a phase, where the results table
# (examples/run_fixture_eval.py, phase 16e) looks for that driver's run;
# the others run in a directory named after the phase
RUN_DIRS = {"14c rgbd_tum": "run_tum", "14d stereo_kitti": "run_kitti",
            "14e stereo_euroc": "run_euroc", "14f mono_tum": "run_mono"}
# phase: (driver, fixture, --auto, trajectory file, KITTI lines,
#         similarity-aligned ATE)
DRIVER_RUNS = {
    "14b rgbd_tum --auto": ("rgbd_tum", "tum_fixture", True,
                            "CameraTrajectory.txt", False, False),
    "14c rgbd_tum": ("rgbd_tum", "tum_fixture", False,
                     "CameraTrajectory.txt", False, False),
    "14d stereo_kitti": ("stereo_kitti", "kitti_fixture", False,
                         "CameraTrajectory.txt", True, False),
    "14e stereo_euroc": ("stereo_euroc", "euroc_fixture", False,
                         "CameraTrajectory.txt", False, False),
    "14f mono_tum": ("mono_tum", "tum_fixture", False,
                     "KeyFrameTrajectory.txt", False, True),
}
# The JAX package's drivers (examples/*.py, default System pipelining) on
# the same fixtures, written by scripts/make_fixture_dataset.py's
# functions, on the CPU:
#   JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py drivers
# share of frames tracked, ATE in m of the trajectory file (SE3-aligned,
# mono similarity-aligned over its keyframes), first tracked frame
DRIVER_REF = {
    "14b rgbd_tum --auto": {"share": 1.0, "ate": 0.002651},
    "14c rgbd_tum": {"share": 1.0, "ate": 0.004244},
    "14d stereo_kitti": {"share": 1.0, "ate": 0.002451},
    "14e stereo_euroc": {"share": 1.0, "ate": 0.002449},
    "14f mono_tum": {"share": 59 / 60, "ate": 0.002761, "boot": 1},
}


def write_fixtures(root: str, workers: int, device=None) -> dict:
    """Phase 14a: the port's fixture writer, the three fixtures at once,
    each rendering on ``device`` (or else in ``workers`` processes); every
    PNG decodes through png.read_png to the array written (the render
    truncated to uint8, depth at 5000 per metre truncated to uint16).
    Returns {fixture: its directory}."""
    makers = {"tum_fixture": fixtures.make_tum_rgbd,
              "kitti_fixture": fixtures.make_kitti_stereo,
              "euroc_fixture": fixtures.make_euroc_stereo}
    parts = {name: {} for name in makers}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(makers)) as pool:
        futures = {name: pool.submit(
            make, os.path.join(root, name), n_frames=FIXTURE_FRAMES[name],
            workers=workers, written=parts[name], device=device)
            for name, make in makers.items()}
        seqs = {name: f.result() for name, f in futures.items()}
    write_s = time.perf_counter() - t0
    written = {path: a for part in parts.values() for path, a in part.items()}
    t0 = time.perf_counter()
    for path, want in written.items():
        got = png.read_png(path)
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    decode_s = time.perf_counter() - t0
    n = sum(FIXTURE_FRAMES.values())
    where = (f"on {device}" if device is not None
             else f"in {len(makers)} x {workers} processes")
    log(f"fixtures: {n} frames, {len(written)} PNGs rendered {where} and "
        f"written in {write_s:.2f} s "
        f"({1000 * write_s / n:.2f} ms per frame); every PNG decodes to "
        f"the array written, {1000 * decode_s / len(written):.3f} ms per "
        "PNG (png.read_png, filter 0)")
    return seqs


def _paeth_png(path: str, rgb: np.ndarray):
    """An RGB PNG whose every row takes the Paeth filter (as most rows of
    an adaptively filtered camera frame do)."""
    h, w, _ = rgb.shape
    cur = rgb.reshape(h, -1).astype(np.int32)
    up = np.vstack([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.hstack([np.zeros_like(cur[:, :3]), cur[:, :-3]])
    ul = np.hstack([np.zeros_like(up[:, :3]), up[:, :-3]])
    pa, pb, pc = (np.abs(up - ul), np.abs(left - ul),
                  np.abs(left + up - 2 * ul))
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, ul))
    rows = np.hstack([np.full((h, 1), 4), (cur - pred) & 0xFF])
    body = rows.astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + (zlib.crc32(kind + data) & 0xFFFFFFFF).to_bytes(4, "big"))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", w.to_bytes(4, "big")
                + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0]))
                + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


def check_readers(seqs: dict, root: str):
    """Phase 14a, the readers: the native loader (where g++ and libpng's
    header exist) against the plain reader on the TUM fixture, and the
    plain reader's and the native loader's ms per frame; the plain
    decode of a Paeth-filtered 640x480 RGB frame."""
    ds = datasets.TumRgbdDataset(seqs["tum_fixture"])
    t0 = time.perf_counter()
    plain = list(ds)
    plain_ms = 1000 * (time.perf_counter() - t0) / len(plain)
    gxx = native_loader.toolchain()
    if gxx is None:
        log("native frame loader: not built on this machine (no g++ or no "
            "libpng header, png.h); prefetch() iterates the plain reader")
        native_ms = None
    else:
        assert native_loader.get_lib() is not None
        t0 = time.perf_counter()
        native = list(ds.prefetch())
        native_ms = 1000 * (time.perf_counter() - t0) / len(native)
        assert len(native) == len(plain)
        for a, b in zip(native, plain):
            assert a[0] == b[0] and np.array_equal(a[1], b[1]) \
                and np.array_equal(a[2], b[2]), "native frame differs"
        log(f"native frame loader: built with {gxx}; its frames equal the "
            "plain reader's on the TUM fixture")
    rgb = np.random.default_rng(0).integers(0, 256, (480, 640, 3))
    rgb[:240] = np.sort(rgb[:240], axis=1)
    path = os.path.join(root, "paeth.png")
    _paeth_png(path, rgb)
    t0 = time.perf_counter()
    for _ in range(3):
        gray = datasets._imread_gray(path)
    paeth_ms = 1000 * (time.perf_counter() - t0) / 3
    assert np.array_equal(png.read_png(path), rgb.astype(np.uint8))
    assert gray.shape == (480, 640)
    log(f"readers (host clock, ms per frame): plain reader {plain_ms:.3f} "
        f"(rgb + 16-bit depth, filter 0), native loader "
        f"{'not built' if native_ms is None else f'{native_ms:.3f}'}; plain "
        f"decode of a Paeth-filtered 640x480 RGB frame to gray "
        f"{paeth_ms:.2f}")


@contextlib.contextmanager
def constructed(*classes):
    """Within the block, every instance of ``classes`` made is appended to
    the yielded list (to read a driver's tracker after its main())."""
    made, saved = [], [(cls, cls.__init__) for cls in classes]

    def keep(init):
        def run(self, *a, **kw):
            init(self, *a, **kw)
            made.append(self)
        return run

    for cls, init in saved:
        cls.__init__ = keep(init)
    try:
        yield made
    finally:
        for cls, init in saved:
            cls.__init__ = init


@contextlib.contextmanager
def jax_schedule():
    """Within the block, every AutoTracker made runs the JAX package's
    maintenance schedule, one phase a tracked frame
    (AutoTrackerConfig(whole_cycle=False)), for a gate held to the JAX
    package's own run of a driver."""
    init = AutoTracker.__init__

    def run(self, cfg, auto_cfg=None, device="cuda"):
        init(self, cfg, dataclasses.replace(
            auto_cfg or AutoTrackerConfig(), whole_cycle=False), device)

    AutoTracker.__init__ = run
    try:
        yield
    finally:
        AutoTracker.__init__ = init


def driver_argv(name: str, seq: str, auto: bool) -> list:
    settings = os.path.join(seq, "settings.yaml")
    args = ([settings, os.path.join(seq, "mav0"),
             os.path.join(seq, "timestamps.txt")] if name == "stereo_euroc"
            else [settings, seq])
    return [name, *args] + (["--auto"] if auto else [])


def read_poses(path: str, kitti: bool):
    """(timestamps or None, Rcw [N,3,3], tcw [N,3]) of a trajectory file:
    TUM lines (ts, twc, qwc) or KITTI lines (Twc, 3x4 row-major), through
    the evaluation scripts' readers."""
    if kitti:
        return (None, *read_kitti_full(path))
    stamps, Rcw, tcw = read_tum_full(path)
    return stamps.tolist(), Rcw, tcw


def fixture_truth(seq: str):
    for name, kitti in (("groundtruth.txt", False),
                        ("groundtruth_tum.txt", False),
                        ("poses_gt.txt", True)):
        path = os.path.join(seq, name)
        if os.path.exists(path):
            return read_poses(path, kitti)
    raise FileNotFoundError(f"no ground truth in {seq}")


def driver_outcome(tracker, auto: bool, run_dir: str, seq: str,
                   traj_file: str, kitti: bool, sim3: bool) -> dict:
    """What a driver's run gave, from the tracker it built (an AutoTracker
    or a System's Tracker, of either package) and the trajectory file it
    wrote: the file has one line per tracked frame (per keyframe for
    KeyFrameTrajectory.txt) with that frame's timestamp; the ATE and the
    RPE (delta 1) of the file's poses against the fixture's ground
    truth."""
    gt_stamps, gt_R, gt_t = fixture_truth(seq)
    if auto:
        out = tracker.finalize()
        ids = np.nonzero(out["valid"])[0].tolist()
        n_kf = int(out["n_keyframes"])
    else:
        ids = [int(rec[0]) for rec in tracker.rel_log]
        n_kf = int(tracker.n_kf_host)
    stamps, R, t = read_poses(os.path.join(run_dir, traj_file), kitti)
    if traj_file == "KeyFrameTrajectory.txt":
        assert len(stamps) == n_kf, "one line per keyframe"
        sel = [gt_stamps.index(s) for s in stamps]
    elif kitti:
        assert len(R) == len(ids), "one KITTI line per tracked frame"
        sel = ids
    else:
        assert stamps == [gt_stamps[i] for i in ids], \
            "one line per tracked frame, with its timestamp"
        sel = ids
    ate = ate_rmse(camera_centers(R, t), camera_centers(gt_R[sel], gt_t[sel]),
                   with_scale=sim3) if len(sel) > 2 else float("nan")
    r = rpe(R, t, gt_R[sel], gt_t[sel]) if len(sel) > 1 else {}
    n = len(gt_R)
    return {"frames": n, "tracked": len(ids), "share": len(ids) / n,
            "first": ids[0] if ids else None, "keyframes": n_kf,
            "lines": len(R), "ate": ate, "rpe_t": r.get("trans_rmse"),
            "rpe_r": r.get("rot_rmse")}


def run_drivers(dev, seqs: dict, root: str) -> dict:
    """Phases 14b-f: each driver's main(argv) in a working directory of its
    own, on the card (the drivers' default device), its tracker read back,
    its trajectory file checked and scored, gated on the JAX drivers'
    outcome on the same fixture (DRIVER_REF). Returns (launches by phase,
    the newest problem of each shape the runs gave the kernels, each
    phase's outcome)."""
    by_phase, outcomes = {}, {}
    with captured_problems() as problems:
        for phase, (name, fix, auto, traj, kitti, sim3) in \
                DRIVER_RUNS.items():
            seq = seqs[fix]
            run_dir = os.path.join(root, RUN_DIRS.get(phase,
                                                      phase.split()[0]))
            os.makedirs(run_dir)
            mod = importlib.import_module(
                "orb_slam2_with_comment_tpu_torch.examples." + name)
            cwd = os.getcwd()
            reset_launches()
            t0 = time.perf_counter()
            with constructed(AutoTracker, System) as made:
                os.chdir(run_dir)
                try:
                    rc = mod.main(driver_argv(name, seq, auto)
                                  + ["--device", str(dev)])
                finally:
                    os.chdir(cwd)
            wall = time.perf_counter() - t0
            assert rc == 0, f"{phase}: main() returned {rc}"
            launches = launch_counts()
            assert len(made) == 1, made
            tracker = made[0] if auto else made[0].tracker
            got = driver_outcome(tracker, auto, run_dir, seq, traj, kitti,
                                 sim3)
            with open(os.path.join(run_dir, "run_summary.json")) as f:
                summary = json.load(f)
            n = got["frames"]
            loop_ms = (1000 / summary["fps"] if auto
                       else summary["mean_ms"])
            ref = DRIVER_REF[phase]
            log(f"{phase}: tracked {got['tracked']}/{n}, first tracked frame "
                f"{got['first']}, {got['keyframes']} keyframes, {traj} "
                f"{got['lines']} lines, ATE {got['ate']:.5f} m "
                f"({'similarity' if sim3 else 'SE3'}-aligned), RPE (delta 1)"
                f" {got['rpe_t']:.5f} m {got['rpe_r']:.5f} rad; ms per frame "
                f"(host clock): {'loop and sync' if auto else 'tracking call'}"
                f" {loop_ms:.2f}, main() {1000 * wall / n:.2f}; reader "
                f"{summary['decode_ms']:.3f} ms per frame; K1 launches per "
                f"frame {k1_launches(launches) / n:.2f} ({launches}); JAX "
                f"drivers on the CPU: {ref}")
            assert got["share"] >= ref["share"] - 0.1, "share tracked"
            assert got["ate"] <= 2 * ref["ate"], "ATE gate"
            if "boot" in ref:
                assert got["first"] <= ref["boot"] + 2, "bootstrap frame"
            assert launches["masked_best_two"] > 0, f"{phase}: K1 not launched"
            by_phase[phase], outcomes[phase] = launches, got
    for key in (*hamming.LAUNCHES, *pose_opt.LAUNCHES):
        assert sum(c[key] for c in by_phase.values()) > 0, \
            f"kernel {key} never launched by the drivers"
    return by_phase, problems, outcomes


def check_undistortion(dev):
    """Phase 13e: undistort_points on the card against the CPU, TUM1's
    distortion (tests/test_geometry.py), 640x480."""
    cam = PinholeCamera.create(517.3, 516.5, 318.6, 255.3,
                               dist=(0.2624, -0.9531, -0.0054, 0.0026, 1.1633))
    uv = torch.rand((2000, 2), generator=torch.Generator().manual_seed(0)) \
        * torch.tensor([630.0, 470.0]) + 5.0
    card = cam.undistort_points(uv.to(dev)).cpu()
    host = cam.undistort_points(uv)
    err = float((card - host).abs().max())
    log(f"undistort_points card vs cpu: max |diff| {err:.2e} px over 2000 "
        f"points (largest shift {float((host - uv).abs().max()):.2f} px)")
    assert err < 1e-3


# ---------------------------------------------------------------------------
# phase 15: the multi-device paths, the viewer and the AR driver, dense BoW
# ---------------------------------------------------------------------------

def run_multi_seq(dev):
    """Phase 15a: MultiSeqTracker at the bench configuration (loop closing
    off), B = 2 worlds (seeds 0 and 1) over the orbit's first
    MULTI_FRAMES frames, in a world of one. Returns (launches, the newest
    problem of each shape the run gave the kernels, sequence 0's final
    map)."""
    n = MULTI_FRAMES
    poses = orbit_trajectory(n_frames=60)[:n]
    worlds = [frames_of("orbit_seed0"), frames_of("orbit60")[:n]]
    auto_cfg = AutoTrackerConfig(traj_capacity=8 * n, loop_closing=False)
    mt = MultiSeqTracker(bench_cfg(), n_seq=2, auto_cfg=auto_cfg, device=dev)
    batches = [(np.stack([w[i][0] for w in worlds]),
                np.stack([w[i][1] for w in worlds])) for i in range(n)]
    reset_launches()
    with captured_problems() as problems:
        step_ms = [synced_ms(lambda: mt.process_rgbd(*b)) for b in batches]
    launches = launch_counts()
    outs = mt.finalize()
    step_ms = np.array(step_ms)
    k1 = k1_launches(launches)
    log(f"multi seq: {n} B-frame steps of 2 sequences: ms per step "
        f"{step_ms.mean():.2f} (median {np.median(step_ms):.2f}, after the "
        f"first {step_ms[1:].mean():.2f}), ms per sequence-frame "
        f"{step_ms.mean() / 2:.2f}; K1 launches {launches}, "
        f"{k1 / (2 * n):.2f} per sequence-frame")
    for i, out in enumerate(outs):
        t_err = [np.linalg.norm(out["t"][k] - poses[k][1]) for k in range(n)]
        log(f"multi seq {i}: initialized {out['initialized']}, lost at "
            f"{out['lost_at']}, {int(out['valid'].sum())}/{n} valid, "
            f"{out['n_keyframes']} keyframes, median t err "
            f"{np.median(t_err):.5f} m")
        assert out["initialized"] and out["lost_at"] == -1, f"seq {i} lost"
        assert out["valid"].all() and np.median(t_err) < 0.02, \
            f"seq {i} accuracy gate"
    solo = AutoTracker(bench_cfg(), auto_cfg, device=dev)
    for img, depth in worlds[0]:
        solo.process_rgbd(img, depth)
    ref = solo.finalize()
    dt = float(np.abs(outs[0]["t"] - ref["t"]).max())
    dR = float(np.abs(outs[0]["R"] - ref["R"]).max())
    log(f"multi seq 0 against a solo AutoTracker: valid equal "
        f"{np.array_equal(outs[0]['valid'], ref['valid'])}, keyframes "
        f"{outs[0]['n_keyframes']} / {ref['n_keyframes']}, max |t| diff "
        f"{dt:.2e} m, max |R| diff {dR:.2e} (index_add_ sums in no fixed "
        f"order on the card)")
    assert np.array_equal(outs[0]["valid"], ref["valid"])
    assert outs[0]["n_keyframes"] == ref["n_keyframes"]
    assert dt < 1e-4 and dR < 1e-4, "sequence 0 left its solo run"
    assert not missing(launches), \
        f"kernels {missing(launches)} never launched by MultiSeqTracker"
    return launches, problems, mt.states[0].map


def run_world_of_one(dev, m):
    """Phase 15b: a torch.distributed group of one rank through NCCL on the
    card: dist_ba and dist_pose_graph against the single-device solvers on
    the same fixed schedule, then a global BA of phase 15a's map through
    LoopCloser.poll_gba's process-group branch; then the launcher with
    one rank on the card."""
    auto_loop.warm_up_autodiff()  # the pose graph's forward-mode Jacobians
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}", rank=0,
        world_size=1, device_id=dev)
    try:
        cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
        prob, t_gt = launch.ba_demo_problem(dev, n_poses=8, n_pts=4096)
        box = {}
        ms = synced_ms(lambda: box.update(out=dist_ba.ba_solve_sharded(
            cam, dist_ba.shard_problem(prob), iters=8)))
        R, t, X, chi2 = box["out"]
        X = dist_ba.gather_points(X)
        ref_ms = synced_ms(lambda: box.update(ref=ba.ba_solve(
            cam, prob, iters=8, robust=True, accept_all=True)))
        ref = box["ref"]
        gap = max(float((a - b).abs().max())
                  for a, b in ((R, ref.R), (t, ref.t), (X, ref.X)))
        err = float((t.cpu() - torch.as_tensor(t_gt)).abs().max())
        log(f"nccl world of one: dist_ba 8 poses x 4096 landmarks, 8 steps "
            f"{ms:.2f} ms (single device, same schedule {ref_ms:.2f} ms), "
            f"max |diff| {gap:.2e}, max pose error {err:.5f} m, chi2 "
            f"{float(chi2):.3f}")
        assert gap < 1e-4 and err < 0.02 and np.isfinite(float(chi2))
        pg, _ = launch.ring_problem(dev, n=64, pad_to=1)
        ms = synced_ms(lambda: box.update(pg=(
            dist_pose_graph.optimize_pose_graph_sharded(
                dist_pose_graph.shard_edges(pg), iters=20))))
        ref_ms = synced_ms(lambda: box.update(pg_ref=(
            pose_graph.optimize_pose_graph(pg, iters=20, accept_all=True))))
        res, pref = box["pg"], box["pg_ref"]
        gap = max(float((getattr(res, f) - getattr(pref, f)).abs().max())
                  for f in ("R", "t", "s"))
        log(f"nccl world of one: dist_pose_graph 64 vertices, 20 steps "
            f"{ms:.2f} ms (single device {ref_ms:.2f} ms), max |diff| "
            f"{gap:.2e}, chi2 {float(res.chi2):.3e}")
        assert gap < 1e-4 and float(res.chi2) < 1e-4
        db = KeyFrameDatabase(V.load_default_vocabulary(dev),
                              m.kf_R.shape[0])
        cfg = bench_cfg()
        lc = LoopCloser(cfg.cam, db, width=cfg.width, height=cfg.height)
        lc.mesh = dist.group.WORLD
        lc._start_gba(m)
        g = dict(lc._gba)
        polls, out = 0, None
        t0 = time.perf_counter()
        while out is None and polls < 10:
            out = lc.poll_gba(m)
            polls += 1
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        sol = ba.ba_solve(cfg.cam, g["prob"], iters=lc.gba_total_iters,
                          robust=True, init_lambda=1e-4, accept_all=True)
        want = lc._apply_gba(m, {**g, "prob": g["prob"]._replace(
            R=sol.R, t=sol.t, X=sol.X)})
        gap = max(float((getattr(out, f) - getattr(want, f)).abs().max())
                  for f in ("kf_R", "kf_t", "lm_pw"))
        moved = float((out.kf_t - m.kf_t).abs().max())
        log(f"nccl world of one: poll_gba through the group, Pp {g['Pp']} "
            f"Lp {g['Lp']}, {polls} polls in {ms:.2f} ms, max |diff| against "
            f"the single-device schedule {gap:.2e}, keyframes moved up to "
            f"{moved:.5f} m")
        assert out is not None and polls == 5 and gap < 1e-4
        assert torch.isfinite(out.lm_pw).all() and moved < 0.05
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "orb_slam2_with_comment_tpu_torch.parallel.launch",
         "--nprocs", "1", "--device", "cuda", "--timeout", "150"],
        capture_output=True, text=True, timeout=180)
    out = proc.stdout + proc.stderr
    log(f"launcher, one rank on the card: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; "
        + " | ".join(ln for ln in proc.stdout.splitlines() if "rank" in ln))
    assert proc.returncode == 0 and out.count("DISTRIBUTED OK") == 1, \
        out[-3000:]


def _http(port, path, doc=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if doc is None else json.dumps(doc).encode(),
        method="GET" if doc is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def run_viewer_and_ar(dev, workers):
    """Phase 15c: System(use_viewer=True) at the bench configuration over
    10 orbit frames, every endpoint over HTTP; then the mono_ar driver's
    synthetic mode over its default 80 frames."""
    frames = frames_of("orbit60")[:10]
    slam = System(bench_cfg(), Sensor.RGBD, use_viewer=True, viewer_port=0,
                  device=dev)
    port = slam.viewer.port
    try:
        for i, (img, depth) in enumerate(frames):
            slam.track_rgbd(img, depth, i / 30.0)
        tr = slam.tracker
        tr.flush()
        page = _http(port, "/")
        doc = json.loads(_http(port, "/state.json"))
        t0 = time.perf_counter()
        data = _http(port, "/frame.png")
        png_ms = 1000 * (time.perf_counter() - t0)
        obs = tr.last_obs
        want = draw_frame(np.asarray(frames[-1][0], np.float32),
                          obs.feats.xy.cpu().numpy(), obs.lm.cpu().numpy(),
                          obs.feats.valid.cpu().numpy(), state=tr.state.name,
                          n_kf=tr.n_kf_host, n_lm=int(tr.map.lm_valid.sum()))
        got = png.decode_png(data)
        log(f"viewer: page {len(page)} bytes; state {doc['state']}, "
            f"{len(doc['points'])} points, {len(doc['keyframes'])} "
            f"keyframes, {len(doc['edges'])} edges; frame.png {len(data)} "
            f"bytes {got.shape} in {png_ms:.1f} ms, equal to draw_frame of "
            f"the frame: {np.array_equal(got, want)}")
        assert b"live viewer" in page and doc["state"] == "OK"
        assert len(doc["points"]) > 100 and doc["camera"] is not None
        assert np.array_equal(got, want)
        _http(port, "/control", {"localization": True})
        assert tr.localization_only
        _http(port, "/control", {"localization": False})
        assert not tr.localization_only
    finally:
        slam.shutdown()
    assert slam.viewer is None
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "ar")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mono_ar.main(["mono_ar", "--synthetic", f"--out={out_dir}",
                               f"--device={dev}", f"--workers={workers}"])
        secs = time.perf_counter() - t0
        text = buf.getvalue().strip()
        files = sorted(os.listdir(out_dir))
        last = png.read_png(os.path.join(out_dir, files[-1])) if files \
            else None
        cube = (int((last == np.array([235, 60, 200])).all(axis=2).sum())
                if last is not None else 0)
        log(f"mono_ar --synthetic (80 frames, {workers} render workers): "
            f"exit {rc} in {secs:.1f} s; {text.replace(chr(10), ' | ')}; "
            f"{len(files)} overlays, the last {None if last is None else last.shape} "
            f"with {cube} cube pixels")
        assert rc == 0 and "new virtual cube inserted" in text, "no plane"
        assert len(files) >= 60 and last.shape == (500, 640, 3) and cube > 0


def check_dense_bow(dev):
    """Phase 15d: dense bow_vectors and score_l1 on the card against the
    CPU, with the packaged vocabulary, over the words of 20 orbit frames."""
    voc, voc_cpu = V.load_default_vocabulary(dev), V.load_default_vocabulary(
        "cpu")
    ext = OrbExtractor(n_features=1000)
    words, valid, host_words = [], [], []
    for img, _ in frames_of("orbit60")[::3]:
        f = ext(torch.as_tensor(img, device=dev))
        words.append(V.transform(voc, f.desc, f.valid))
        valid.append(f.valid)
        host_words.append(V.transform(voc_cpu, f.desc.cpu(), f.valid.cpu()))
    words, valid = torch.stack(words), torch.stack(valid)
    host_words = torch.stack(host_words)
    box = {}
    ms = synced_ms(lambda: box.update(v=V.bow_vectors(voc, words, valid)))
    vv = box["v"]
    s_ms = synced_ms(lambda: box.update(s=V.score_l1(vv[0], vv)))
    t0 = time.perf_counter()
    host = V.bow_vectors(voc_cpu, words.cpu(), valid.cpu())
    host_s = V.score_l1(host[0], host)
    cpu_ms = 1000 * (time.perf_counter() - t0)
    log(f"dense BoW: {tuple(vv.shape)} rows in {ms:.2f} ms, score_l1 "
        f"{s_ms:.2f} ms on the card ({cpu_ms:.1f} ms both on the CPU); "
        f"words equal {torch.equal(words.cpu(), host_words)}, rows equal "
        f"{torch.equal(vv.cpu(), host)}, scores equal "
        f"{torch.equal(box['s'].cpu(), host_s)}; scores "
        f"{[round(float(x), 4) for x in host_s[:5]]}")
    assert torch.equal(words.cpu(), host_words)
    assert torch.equal(vv.cpu(), host) and torch.equal(box["s"].cpu(), host_s)


# ---------------------------------------------------------------------------
# phase 16: localization, batched dispatch, the street circuit, the
# vocabulary evaluation and the results table
# ---------------------------------------------------------------------------

def run_localization(dev, mapper, root):
    """Phase 16a: ``mapper``'s state (phase 6's tracker: the orbit mapped)
    saved, loaded into a localization-mode AutoTracker, and the orbit
    re-tracked; then phase 6's black frames and frames 2-4. Returns (the
    pass's launches, the newest problem of each shape it gave the
    kernels)."""
    n = 60
    poses = orbit_trajectory(n_frames=n)
    frames = frames_of("orbit60")
    path = os.path.join(root, "map16a.npz")
    checkpoint.save_auto_state(path, mapper)
    loc = AutoTracker(bench_cfg(), AutoTrackerConfig(localization_only=True),
                      device=dev)
    checkpoint.load_auto_state(path, loc)
    n_kf, start = int(loc.state.map.n_kf), loc.frame_count
    black = (np.zeros((480, 640), np.uint8), np.zeros((480, 640), np.uint16))
    reset_launches()
    with captured_problems() as problems:
        ms, wall = bench.timed_pass(loc, loc.process_rgbd, frames)
        launches = launch_counts()
        for img, depth in [black] * 3 + frames[2:5]:
            loc.process_rgbd(img, depth)
    out = loc.finalize()
    t_med, r_med = bench.pose_errors(out, poses, offset=start)
    seg = slice(start, start + n)
    r = start + n + 3  # the first revisit frame
    k1_per_frame = k1_launches(launches) / n
    log(f"localization: {n} frames against the saved map of {n_kf} keyframe "
        f"slots, {ms:.3f} ms per frame (CUDA events), {wall:.3f} (host "
        f"clock); valid {int(out['valid'][seg].sum())}/{n}, median t err "
        f"{t_med:.5f} m, rot err {r_med:.4f} deg; K1 {k1_per_frame:.2f} "
        f"launches per frame ({launches}); after 3 black frames: stats "
        f"{out['stats'][r].tolist()}, t err "
        f"{np.linalg.norm(out['t'][r] - poses[2][1]):.5f} m; keyframe slots "
        f"{out['n_keyframes']}, lost_at {out['lost_at']}")
    assert out["n_keyframes"] == n_kf, "localization inserted a keyframe"
    assert not (out["stats"][start:, 6] == 1).any(), "a keyframe insert"
    assert out["valid"][seg].all(), "a localization frame is invalid (lost)"
    assert t_med < 0.02 and r_med < 1.0, "localization pose error gate"
    assert not out["valid"][start + n:r].any(), "a black frame is valid"
    assert out["stats"][r, 6] == 2, "did not relocalize"
    assert not (out["stats"][start:, 6] == 3).any(), "the map was reset"
    assert out["valid"][r:].all() and out["lost_at"] == -1
    assert np.linalg.norm(out["t"][r] - poses[2][1]) < 0.05
    assert launches["masked_best_two"] > 0, "K1 not launched"
    return launches, problems


def run_batched(dev):
    """Phase 16b: batch_frames=4 against batch_frames=1 over 10 orbit
    frames (two batches, then drain() of two), bit for bit."""
    frames = frames_of("orbit60")[:10]
    outs, ms = {}, {}
    for b in (4, 1):
        tr = AutoTracker(bench_cfg(), AutoTrackerConfig(
            loop_closing=False, batch_frames=b), device=dev)

        def run():
            for img, depth in frames:
                tr.process_rgbd(img, depth)
            assert len(tr._batch) == (2 if b == 4 else 0)
            tr.drain()
        ms[b] = synced_ms(run) / len(frames)
        assert not tr._batch
        outs[b] = tr.finalize()
    a, o = outs[4], outs[1]
    same = all(np.array_equal(a[k], o[k]) for k in ("R", "t", "valid",
                                                    "stats"))
    log(f"batched dispatch: batch_frames=4 {ms[4]:.2f} ms per frame, =1 "
        f"{ms[1]:.2f} (host clock, synced); trajectories equal bit for bit "
        f"{same}, keyframes {a['n_keyframes']} and {o['n_keyframes']}")
    assert same and a["n_keyframes"] == o["n_keyframes"]
    assert a["valid"].all() and a["n_frames"] == len(frames)


# The street circuit (dataio/fixtures.py make_kitti_street): frames and the
# keyframe capacity of phase 16c. 500 frames took 272 s of tracking on an
# H100 80GB HBM3 at 700 W (300 frames: 154 s), so the circuit is cut to 300
# frames (still the whole lap and 8% more, 22 cm a frame). At the JAX
# package's schedule it inserts about 45 keyframes and culls none, and an
# insert needs a live slot below the capacity (in both packages), so no capacity compacts keyframe slots
# here; a capacity of 40 makes the map full before the lap ends. The JAX package's stereo_kitti
# --auto on the same fixture (rendered by numpy), on the CPU:
#   JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py street 300 40
STREET_FRAMES, STREET_KMAX = 300, 40
STREET_REF = {"tracked": 299, "ate": 0.075773, "n_keyframes": 40,
              "n_compact_kf": 0, "n_loops_closed": 0}


@contextlib.contextmanager
def timed_loop_steps():
    """Within the block, box["loop"] gets (synced ms, fired) of each
    close_loop_step call and box["compact"] the synced ms of each keyframe
    or landmark compaction of an insert."""
    box = {"loop": [], "compact": []}
    saved = (auto_loop.close_loop_step, auto.compact_keyframes,
             auto.compact_landmarks)

    def loop_step(loop, *a, **kw):
        res = {}
        ms = synced_ms(lambda: res.setdefault(
            "r", saved[0](loop, *a, **kw)))
        box["loop"].append((ms, res["r"][1].n_loops > loop.n_loops))
        return res["r"]

    def compaction(fn):
        def run(*a):
            res = {}
            box["compact"].append(synced_ms(lambda: res.setdefault(
                "r", fn(*a))))
            return res["r"]
        return run

    auto_loop.close_loop_step = loop_step
    auto.compact_keyframes = compaction(saved[1])
    auto.compact_landmarks = compaction(saved[2])
    try:
        yield box
    finally:
        (auto_loop.close_loop_step, auto.compact_keyframes,
         auto.compact_landmarks) = saved


def run_street(dev, root, workers):
    """Phase 16c: the street circuit written by the port's fixture writer
    (rendered on the card), then examples.eval_street on it. Returns (the
    run's launches, the newest problem of each shape it gave the
    kernels)."""
    fix = os.path.join(root, "kitti_street_fixture")
    t0 = time.perf_counter()
    fixtures.make_kitti_street(fix, n_frames=STREET_FRAMES, workers=workers,
                               device=dev)
    log(f"street fixture: {STREET_FRAMES} stereo pairs at 1241x376 "
        f"rendered on the card, PNGs in {workers} threads, in "
        f"{time.perf_counter() - t0:.2f} s")
    reset_launches()
    t0 = time.perf_counter()
    with jax_schedule(), constructed(AutoTracker) as made, \
            captured_problems() as problems, timed_loop_steps() as steps_ms:
        rc = eval_street.main(["--root", root, "--kmax", str(STREET_KMAX),
                               "--device", str(dev)])
    wall = time.perf_counter() - t0
    assert rc == 0 and len(made) == 1
    launches = launch_counts()
    wd = os.path.join(root, "run_street")
    _, sc = eval_street.score(fix, wd, STREET_KMAX)
    out = made[0].finalize()
    live = int(made[0].state.map.kf_valid.sum())
    n, tracked = out["n_frames"], int(out["valid"].sum())
    summ = sc["summary"]
    fired = [round(ms, 2) for ms, f in steps_ms["loop"] if f]
    quiet = [ms for ms, f in steps_ms["loop"] if not f]
    log(f"street: {n} frames, tracked {tracked}, lost_at {out['lost_at']}, "
        f"{out['n_keyframes']} keyframe slots ({live} live), n_compact_kf "
        f"{out['n_compact_kf']}, n_compact_lm {out['n_compact_lm']}, loops "
        f"closed {out['n_loops_closed']}; {1000 / summ['fps']:.2f} ms per "
        f"frame (the driver's loop and sync, host clock), main() "
        f"{1000 * wall / n:.2f}; reader {summ['decode_ms']:.3f} ms per "
        f"frame; K1 {k1_launches(launches) / n:.2f} launches per frame "
        f"({launches})")
    log(f"street: firing loop steps {fired} ms; {len(quiet)} other "
        f"close_loop_step calls, median "
        f"{np.median(quiet) if quiet else float('nan'):.2f} ms; "
        f"compactions {[round(v, 2) for v in steps_ms['compact']]} ms")
    log(f"street: ATE {sc['ate_m']:.5f} m, drift {sc['trans_pct']:.3f}% / "
        f"{sc['rot_deg_per_m']:.5f} deg/m over {sc['n_segments']} segments, "
        f"path {sc['path_len_m']:.2f} m; the JAX package on the CPU: "
        f"{STREET_REF}")
    assert tracked >= min(n, STREET_REF["tracked"]), "frames tracked"
    assert out["n_keyframes"] == STREET_KMAX == STREET_REF["n_keyframes"], \
        "the map did not fill its keyframe slots"
    assert out["n_compact_kf"] == STREET_REF["n_compact_kf"]
    assert sc["ate_m"] <= 2 * STREET_REF["ate"], "ATE gate"
    assert not missing(launches, stereo=True), \
        f"kernels {missing(launches, True)} never launched on the street"
    return launches, problems


# scripts/eval_vocab.py's run on the CPU, per vocabulary: the same-place and
# different-place scores in world order, the recall and the separation
#   JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py vocab
VOCAB_REF = {
    "vocab_10k.npz": {
        "same": np.array([
            0.43267736, 0.20731884, 0.49846369, 0.24739543, 0.44210374,
            0.24251868, 0.43193409, 0.19033018, 0.48716551, 0.21174738,
            0.44515705, 0.21058156, 0.46078205, 0.22698177, 0.49921930,
            0.19649474, 0.38071123, 0.19245011, 0.42608875, 0.17847905,
            0.48570439, 0.18585551, 0.43100557, 0.19570549,
        ]),
        "diff": np.array([
            0.06871271, 0.13651992, 0.09587616, 0.12349061, 0.11141967,
            0.15888910, 0.08824913, 0.13863857, 0.08427116, 0.11217102,
            0.09497860, 0.13476501, 0.10357593, 0.12438521, 0.09779719,
            0.10093903, 0.10867995, 0.12601753, 0.11275794, 0.12970817,
            0.09017514, 0.11031713, 0.10627998, 0.12724784,
        ]),
        "recall": 1.0, "separation": 2.8326676692984436},
    "vocab_default.npz": {
        "same": np.array([
            0.35663936, 0.10054722, 0.37343958, 0.10997137, 0.33547801,
            0.11394411, 0.35559762, 0.09682974, 0.38199979, 0.10508486,
            0.33011487, 0.09782981, 0.37061587, 0.11365037, 0.39638478,
            0.08312251, 0.25043091, 0.09439942, 0.29274932, 0.09806985,
            0.39592397, 0.08917167, 0.33227298, 0.11060445,
        ]),
        "diff": np.array([
            0.01703413, 0.03655761, 0.01613494, 0.02526964, 0.02911970,
            0.07501486, 0.01971862, 0.04025134, 0.03284021, 0.03760330,
            0.02476541, 0.05244641, 0.00806576, 0.04527218, 0.01444603,
            0.02653825, 0.01888159, 0.04111598, 0.01993904, 0.04595803,
            0.02083892, 0.03750128, 0.00835363, 0.02974685,
        ]),
        "recall": 1.0, "separation": 6.5466846436741415},
}


def run_vocab_eval(dev, renders):
    """Phase 16d: examples.eval_vocab on the card, gated on the JAX
    script's scores: each within 5e-3, the same table cells. ``renders``:
    the futures of the held-out worlds' views, rendered in worker
    processes while phases 16a-c run."""
    t0 = time.perf_counter()
    worlds = [f.result() for f in renders]
    log(f"vocabulary evaluation: waited {time.perf_counter() - t0:.2f} s "
        f"for the {len(worlds)} worlds' renders")
    log(eval_vocab.HEADER)
    for path, label in eval_vocab.VOCABULARIES:
        voc = V.load_vocabulary(path, dev)
        box = {}
        ms = synced_ms(lambda: box.setdefault("r", eval_vocab.evaluate(
            voc, label, worlds, dev)))
        r, ref = box["r"], VOCAB_REF[os.path.basename(path)]
        err = np.abs(np.concatenate([r["same"] - ref["same"],
                                     r["diff"] - ref["diff"]]))
        log(f"{r['row']} ({ms:.1f} ms; {int((err <= 1e-6).sum())} of "
            f"{err.size} scores within 1e-6 of the JAX script's, the largest "
            f"difference {err.max():.2e}; its recall {ref['recall']}, "
            f"separation {ref['separation']:.4f})")
        # a score moves when one of its 600 features lands on another word:
        # the port's pyramid and IC angles differ from XLA's in the last
        # float bits (tests/test_torch_frontend.py), which on the CPU moved
        # 6 of these 96 scores by more than 1e-6, the most by 1.8e-3
        assert err.max() <= 5e-3, "a score differs from the JAX script's"
        assert r["recall"] == ref["recall"]
        # the table's cells: the medians, the separation and the recall
        for key in ("same", "diff"):
            assert (f"{np.median(r[key]):.3f}"
                    == f"{np.median(ref[key]):.3f}"), key
        assert f"{r['separation']:.2f}" == f"{ref['separation']:.2f}"


def check_results_table(root, outcomes):
    """Phase 16e: examples.run_fixture_eval --skip-run over phase 14's run
    directories; its ATE and RPE equal phase 14's scores within 1e-6 (m,
    deg): the table takes a KITTI file's camera centres as written, phase
    14 as -R^T t of the poses read back, whose 10-digit rotations are
    orthonormal to about 1e-9."""
    out = os.path.join(root, "RESULTS.md")
    with contextlib.redirect_stdout(io.StringIO()):
        assert run_fixture_eval.main(["--root", root, "--skip-run",
                                      "--frames", "60", "--out", out]) == 0
    res = run_fixture_eval.score_runs(root)
    rows = run_fixture_eval.table_rows(res, 60)
    with open(out) as f:
        text = f.read()
    pairs = (("run_tum", "14c rgbd_tum", "ate_rmse_m"),
             ("run_kitti", "14d stereo_kitti", "ate_rmse_m"),
             ("run_euroc", "14e stereo_euroc", "ate_rmse_m"),
             ("run_mono", "14f mono_tum", "ate_rmse_m_scaled"))
    for run_dir, phase, key in pairs:
        got, want = res[run_dir], outcomes[phase]
        checks = [(got[key], want["ate"])]
        if "rpe_trans_rmse_m" in got:
            checks += [(got["rpe_trans_rmse_m"], want["rpe_t"]),
                       (got["rpe_rot_rmse_deg"],
                        float(np.degrees(want["rpe_r"])))]
        for a, b in checks:
            assert abs(a - b) <= 1e-6, (run_dir, a, b)
        assert f"{want['ate'] * 100:.1f} cm" in rows[run_dir]
        assert rows[run_dir] in text
        log(f"results table {run_dir}: {rows[run_dir]}")
    assert set(res) == {p[0] for p in pairs}, sorted(res)



# ---------------------------------------------------------------------------
# phase 17: the port's bench
# ---------------------------------------------------------------------------

# the figures whose timed passes run a local BA (K4): every one but the
# KITTI camera's, whose map keeps one keyframe
K4_FIGURES = ("tracking_fps", "map_building_fps", "stereo_fps", "mono_fps")


def run_bench(dev):
    """Phase 17: the port's bench (orb_slam2_with_comment_tpu_torch/bench.py)
    at bench.py's full configuration, driven as bench.run drives it
    (figures, track, report; the kernels are built already), a figure at a
    time so that the phase can watch each. Its JSON line is logged; it
    must have no error, a headline above 0 and every sub-figure. Every
    timed frame of every figure is valid; each timed pass launches K3 at
    least twice a tracked frame; every stereo frame (build and timed
    passes) is one masked_best_two launch of the stereo association; per
    timed frame K1 launches, each K2 kernel once a view, K5 once a stereo
    frame and never elsewhere, K4 on the figures of K4_FIGURES. The mono
    figure keeps the newest inputs of every (calling function, shape) it
    gave the kernels (the copies are made inside its timed passes, so its
    logged times include them). Returns (the run's launches, the mono
    figure's launches over its build and timed passes, its problems)."""
    figs = bench.figures(60, dev)
    runs, mono = [], None
    reset_launches()
    with association_launches() as per_stereo_frame:
        for fig in figs:
            before = launch_counts()
            with (captured_problems() if fig.cfg.sensor == "mono"
                  else contextlib.nullcontext({})) as problems:
                runs.append(bench.track(fig, dev))
            if fig.cfg.sensor == "mono":
                mono = ({k: v - before[k] for k, v in launch_counts().items()},
                        problems)
    launches = launch_counts()
    result = bench.report(figs, runs, dev)
    log(f"bench: {json.dumps(result)}")
    assert "error" not in result and "errors" not in result, result
    assert result["value"] > 0
    passes = result["extra"]["passes"]
    assert set(passes) == {bench.HEADLINE, *bench.SUB_FIGURES}, sorted(passes)
    stereo_frames = 0
    for fig, fig_run in zip(figs, runs):
        n = len(fig.frames)
        log(f"bench {fig.name}: each timed pass's ms a frame by CUDA events "
            f"and by the host clock {fig_run.times}, its K4 launches "
            f"{[p['ba_solve'] for p in fig_run.launches]}, its K1 launches "
            f"{[k1_launches(p) for p in fig_run.launches]}")
        timed = fig_run.tracker.finalize()["valid"][n if fig.build else 0:]
        assert timed.shape == (fig.passes * n,) and timed.all(), \
            f"{fig.name}: not every timed frame valid"
        # a pass from scratch tracks every frame but the first
        tracked = n - (not fig.build)
        assert all(p["pose_lm"] >= 2 * tracked for p in fig_run.launches), \
            f"{fig.name}: fewer than two pose LM launches per tracked frame"
        views = 1 + (fig.cfg.sensor == "stereo")
        stereo_frames += (views - 1) * (fig.build + fig.passes) * n
        per = passes[fig.name]["launches_per_frame"]
        assert per["masked_best_two"] > 0 and per["pose_lm"] > 0, \
            (fig.name, per)
        for k in orb.LAUNCHES:
            assert per[k] == views, (fig.name, k, per[k])
        assert per["stereo_sad"] == views - 1, (fig.name, per["stereo_sad"])
        if fig.name in K4_FIGURES:
            assert per["ba_solve"] > 0, (fig.name, per["ba_solve"])
    assert per_stereo_frame == [1] * stereo_frames, \
        "the stereo association is not one masked_best_two launch per frame"
    log("bench launches per timed frame: " + str(
        {name: p["launches_per_frame"] for name, p in passes.items()}))
    return launches, *mono


# ---------------------------------------------------------------------------
# phase 18: the configurations beyond the kernels' first variants
# ---------------------------------------------------------------------------

BEYOND_MAP = MapConfig(k_max=24, n_feat=1000, l_max=8000, d_max=48)


def beyond_rgbd(dev) -> dict:
    """Phase 18a: the bench's RGB-D configuration with MapConfig(d_max=48)
    over the first 30 orbit frames through AutoTracker on the card, held to
    phase 4's tracking gates; every dense BA solve takes K4's wide variant.
    Returns the launches."""
    n = 30
    poses = orbit_trajectory(n_frames=60)[:n]
    tracker = AutoTracker(bench_cfg(BEYOND_MAP), AutoTrackerConfig(
        traj_capacity=4 * n, loop_closing=False), device=dev)
    ms, wall = bench.timed_pass(tracker, tracker.process_rgbd,
                                frames_of("orbit60")[:n])
    launches = launch_counts()
    out = tracker.finalize()
    t_med, r_med = bench.pose_errors(out, poses)
    tracked = int(out["valid"].sum()) - 1
    log(f"beyond, RGB-D d_max 48: {ms:.3f} ms/frame (CUDA events), "
        f"{wall:.3f} (host clock); initialized={out['initialized']} "
        f"lost_at={out['lost_at']} valid={int(out['valid'].sum())}/{n} "
        f"keyframes={out['n_keyframes']}; median t err {t_med:.5f} m, rot "
        f"err {r_med:.4f} deg; K4 {launches['ba_solve']} solves, "
        f"{launches['ba_solve_wide']} in the wide variant; launches "
        f"{launches}")
    assert out["initialized"] and out["lost_at"] == -1, "tracking lost"
    assert out["valid"].all(), "not every frame valid"
    assert 3 <= out["n_keyframes"] <= 24, out["n_keyframes"]
    assert t_med < 0.02 and r_med < 1.0, "pose error gate"
    assert not missing(launches), \
        f"kernels {missing(launches)} never launched at d_max 48"
    assert launches["pose_lm"] >= 2 * tracked, \
        "fewer than two pose LM launches per tracked frame"
    assert launches["ba_solve"] > 0, "no dense BA solve at d_max 48"
    assert launches["ba_solve_wide"] == launches["ba_solve"], \
        "a solve at d_max 48 not in K4's wide variant"
    return launches


def beyond_stereo(dev):
    """Phase 18b: the KITTI-camera pair through
    OrbExtractor(BEYOND_EXT).stereo on the card (24 levels of 30 px cells:
    levels 20-23 under 11 rows). The left features against the plain chain
    on the call's own pyramid (image.build_pyramid on the card, what the
    call builds), with phase 3's K2 gates (hold_describe's, the angles on
    the valid slots); the right u and depth against stereo_depth_plain on
    the call's own association (the right view through the same
    extractor, K1 on the association mask) in bits, phase 3's K5 gate. Then
    against the same call on the CPU, whose pyramid rounds otherwise (the
    resize products sum in another order): the keypoints with a depth on
    one side and not the other at most 5% of those with one, and 95% of
    the depths both give within 1e-3 relative."""
    kl, kr = (torch.as_tensor(first_frames(s, 1)[0], device=dev)
              for s in ("kitti30_left", "kitti30_right"))
    bf, fx = bench.KITTI_BF, bench.KITTI_CAM["fx"]
    ext = OrbExtractor(**BEYOND_EXT)
    before = {**orb.VARIANT_LAUNCHES, **sad.VARIANT_LAUNCHES}
    t0 = time.perf_counter()
    feats, sd = ext.stereo(kl, kr, bf, fx)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for k in ("orb_cells_any", "orb_far"):
        assert orb.VARIANT_LAUNCHES[k] > before[k], k
    for k in sad.VARIANT_LAUNCHES:
        assert sad.VARIANT_LAUNCHES[k] > before[k], k
    name = "KITTI pair, 24 levels of 30 px cells"
    pyr = image.build_pyramid(kl.to(torch.float32), ext.n_levels,
                              ext.scale_factor)
    levels = orb.level_table(tuple(tuple(p.shape) for p in pyr),
                             tuple(ext.budgets), tuple(ext.scales), ext.cell)
    n_small = sum(lv.h < sad.PATCH for lv in levels)
    assert len(levels) == 24 and n_small >= 4
    flat = orb.pack(pyr)
    plain = (ext.margin, ext.th_high, ext.th_low, ext.per_cell)
    want = orb.extract_levels_plain(flat, levels, *plain)
    for part, a, b in zip(("xy", "response", "octave"), feats[:3],
                          want[:3]):
        assert torch.equal(a, b), f"stereo front end beyond: {part}"
    assert torch.equal(feats.valid, want[5]), "stereo front end beyond: valid"
    yx = orb.select_plain(*orb.cells_plain(flat, levels, *plain)[2:],
                          levels)[0]
    kept = (orb.moment_cancellation(flat, yx, levels) >= 1e-3) & want[5]
    err, _, rows, bits, n_rows = hold_describe(
        "the stereo front end beyond",
        (feats.xy, feats.octave, feats.angle, feats.desc),
        (want[0], want[2], want[3], want[4]), want[5], kept, True, name)
    right = ext(kr)  # the right view through the same kernels
    f32 = sad._f32
    mask = stereo.association_mask(feats, right, ext.scales, f32(fx))
    best_d, best_j, _, _ = hamming.masked_best_two(feats.desc, right.desc,
                                                   mask)
    pyr_r = image.build_pyramid(kr.to(torch.float32), ext.n_levels,
                                ext.scale_factor)
    u, d = sad.stereo_depth_plain(flat, orb.pack(pyr_r), levels, feats.xy,
                                  right.xy, best_d, best_j, f32(bf), f32(fx))
    assert torch.equal(_bits(sd.u_right), _bits(u)) and \
        torch.equal(_bits(sd.depth), _bits(d)), \
        "stereo front end beyond: right u or depth not the plain bits"
    t0 = time.perf_counter()
    _, want_sd = ext.stereo(kl.cpu(), kr.cpu(), bf, fx)
    cpu_s = time.perf_counter() - t0
    dc, dp = sd.depth.cpu(), want_sd.depth
    either, both = (dc > 0) | (dp > 0), (dc > 0) & (dp > 0)
    one_side = int((either & ~both).sum())
    close = ((dc - dp).abs() <= 1e-3 * dp.abs())[both]
    log(f"beyond, stereo front end ({name}, {n_small} levels under 11 "
        f"rows): card {card_s:.3f} s, CPU {cpu_s:.3f} s; features the "
        f"plain chain's on the call's pyramid, angles within {err:.3g} on "
        f"valid slots, descriptor rows differing {int(rows.sum())} "
        f"({n_rows} valid, at most {int(bits.max()) if len(bits) else 0} "
        f"bits); right u and depth stereo_depth_plain's bits "
        f"({int((d > 0).sum())} with a depth); against the CPU call: "
        f"{int(either.sum())} with a depth on either side, {one_side} on one "
        f"side only, {int(close.sum())} of {int(both.sum())} within 1e-3")
    assert int((d > 0).sum()) > 300, "too few stereo matches"
    assert one_side <= 0.05 * int(either.sum())
    assert int(close.sum()) >= 0.95 * int(both.sum())


def beyond_entry_points(dev):
    """Phase 18c: the other lifted shapes through their entry points:
    OrbExtractor(n_features=140000) on the 2560x1440 frame (orb_select's
    global scratch), optimize_pose at [1 x 65,536] and [1 x 131,072] (a
    cluster of 16; the edges from global memory), masked_best_two at
    [4 x 4,194,321] (the 64-bit key); each variant launched, the results
    finite (phase 3 held each against its plain version)."""
    w, h = 2560, 1440
    f = 500.0 * w / 640.0
    big = render_job((0.0, [orbit_trajectory(n_frames=60)[7]],
                      dict(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h),
                      "image"), dev)[0]
    feats = OrbExtractor(n_features=140000)(torch.as_tensor(big, device=dev))
    assert int(feats.valid.sum()) > 500
    for i, n in enumerate((65536, 131072)):
        p = pose_problem("outliers", 600 + i, 1, n)
        out = pose_opt.optimize_pose(POSE_CAM, *(
            torch.as_tensor(p[k]).to(dev) for k in (
                "R0", "t0", "Xw", "obs_uvr", "inv_sigma2", "valid")))
        assert int(out.n_inliers[0]) > 0.7 * n and \
            bool(torch.isfinite(out.R).all())
    gen = torch.Generator().manual_seed(18)
    n = hamming.NARROW_TARGETS + 17
    dq, dt = random_desc(gen, 4).to(dev), random_desc(gen, n).to(dev)
    mask = torch.rand((4, n), generator=gen).lt(0.01).to(dev)
    best = hamming.masked_best_two(dq, dt, mask)[0]
    assert bool((best <= 256).all())


def run_beyond(dev) -> dict:
    """Phase 18 (a-c). Returns the launches of the three parts: every
    variant of every kernel among them."""
    reset_launches()
    launches = beyond_rgbd(dev)
    beyond_stereo(dev)
    beyond_entry_points(dev)
    launches = launch_counts()
    variants = {**hamming.VARIANT_LAUNCHES, **pose_opt.VARIANT_LAUNCHES,
                **orb.VARIANT_LAUNCHES, **sad.VARIANT_LAUNCHES,
                **ba.VARIANT_LAUNCHES}
    log(f"beyond: the variants' launches {variants}")
    assert all(variants.values()), f"a variant never launched: {variants}"
    return launches


def main():
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        raise SystemExit("usage: python3 chip_smoke.py [--kernels-only]")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    t_run = t0 = time.perf_counter()
    libs = ["hamming", "hamming_v1", "pose_lm", "pose_lm_v1", "orb",
            "orb_v1", "stereo_sad", "stereo_sad_v1", "ba", "ba_v1"]
    cuda_lib.build_all(libs)
    cuda_lib.load("hamming")
    pose_opt._kernel_lib()
    orb._kernel_lib()
    sad._kernel_lib()
    sad._v1_kernel_lib()
    log(f"built csrc/{', csrc/'.join(libs)} (.cu) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        log(cuda_lib.build_logs.get(name, "").strip())
    for name, lib in (("orb", None), ("orb_v1", base_orb().lib)):
        log(f"csrc/{name}.cu resident blocks per SM (orb_cells, "
            f"orb_describe): {orb.resident_blocks(lib)}")
    ba._kernel_lib()
    count_frames()
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    if not kernels_only:
        t0 = time.perf_counter()
        render_all(workers, device=dev)
        log(f"rendered {sum(len(f) for f in _FRAMES.values())} frames of "
            f"{len(_FRAMES)} sequences on the card in "
            f"{time.perf_counter() - t0:.2f} s")
    t3 = time.perf_counter()
    rows = (check_kernels(dev) + [check_pose_kernel(dev)]
            + check_orb_kernels(dev) + [check_sad_kernel(dev)]
            + [check_ba_kernel(dev)])
    t3b = time.perf_counter()
    rows += check_variants(dev)
    log(f"phase 3 in {time.perf_counter() - t3:.1f} s (the variants "
        f"{time.perf_counter() - t3b:.1f} s)")
    if kernels_only:
        log(json.dumps({"kernels": rows}))
        return
    by_phase = {}
    by_phase["4 rgbd slice"], slice_problems = run_slice(dev)
    compare_devices(dev)
    by_phase["6 default rgbd"], rgbd_build, rgbd_tracker = run_default(dev)
    by_phase["7 controlled loop"], _ = run_controlled_loop(dev)
    run_compaction(dev)
    by_phase["9 stereo bench"], stereo_problems = run_stereo_bench(
        dev, rgbd_build)
    by_phase["10 stereo kitti"], kitti_problems = run_stereo_kitti(dev)
    by_phase["11 mono bench"], mono_tracker, mono_problems = run_mono(dev)
    compare_initializer(dev)
    for k_max, fix_scale in ((96, True), (300, True), (300, False)):
        key = f"12 loop k_max {k_max}" + ("" if fix_scale else " free scale")
        # the free-scale gate on the position error is the JAX package's
        # outcome on the same frames on the CPU (0.0397 -> 0.0179 m, a
        # share of 0.450: the Sim3 of a 15 cm baseline leaves that much)
        by_phase[key], _ = run_controlled_loop(
            dev, MapConfig(k_max, 1000, 10000, 8), fix_scale,
            label="loop above 64 slots",
            seq="loop18" if fix_scale else "loop18_shifted",
            drift_gate=0.35 if fix_scale else 0.5, rerun=False)
    by_phase["13a system rgbd"], system_problems = run_system_rgbd(dev)
    by_phase["13b host loop"] = run_host_loop(dev)
    by_phase["13c lifecycle"], life_problems = run_lifecycle(dev)
    check_undistortion(dev)
    with tempfile.TemporaryDirectory() as root:
        seqs = write_fixtures(root, max(1, workers // 2), dev)
        check_readers(seqs, root)
        drivers, driver_problems, outcomes = run_drivers(dev, seqs, root)
        by_phase.update(drivers)
        t15 = time.perf_counter()
        by_phase["15a multi seq"], multi_problems, multi_map = \
            run_multi_seq(dev)
        run_world_of_one(dev, multi_map)
        run_viewer_and_ar(dev, workers)
        check_dense_bow(dev)
        log(f"phase 15 in {time.perf_counter() - t15:.1f} s")
        t16 = time.perf_counter()
        with concurrent.futures.ProcessPoolExecutor(
                max(1, workers // 2),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            renders = [pool.submit(eval_vocab.world_views, seed)
                       for seed in eval_vocab.HELD_OUT_SEEDS]
            by_phase["16a localization"], loc_problems = run_localization(
                dev, rgbd_tracker, root)
            del rgbd_tracker
            run_batched(dev)
            by_phase["16c street"], street_problems = run_street(
                dev, root, workers)
            run_vocab_eval(dev, renders)
        check_results_table(root, outcomes)
        log(f"phase 16 in {time.perf_counter() - t16:.1f} s")
    t17 = time.perf_counter()
    by_phase["17 bench"], bench_mono, bench_mono_problems = run_bench(dev)
    log(f"phase 17 in {time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    by_phase["18 beyond"] = run_beyond(dev)
    log(f"phase 18 in {time.perf_counter() - t18:.1f} s")
    # the mono path's kernels over phase 11's pass and the bench's mono
    # figure: phase 11's build pass inserts so often that its maintenance
    # cycles seldom reach the duplicate merge (distance_matrix)
    mono_launches = {k: c + bench_mono[k]
                     for k, c in by_phase["11 mono bench"].items()}
    log(f"mono path: launches of phase 11 and the bench's mono figure "
        f"{mono_launches}")
    assert not missing(mono_launches), \
        f"kernels {missing(mono_launches)} never launched on the mono path"
    check_mono_problems(dev, mono_tracker,
                        {**mono_problems, **bench_mono_problems}, rows)
    # K4 on the dense BA problems of phases 4 and 9-11 (phase 11's in
    # check_mono_problems); the later paths give it the same shapes
    later = [row for row in (
        captured_todo("system rgbd", system_problems)
        + captured_todo("lifecycle", life_problems)
        + captured_todo("drivers", driver_problems)
        + captured_todo("multi seq", multi_problems)
        + captured_todo("localization", loc_problems)
        + captured_todo("street", street_problems)) if row[1] != "ba"]
    hold_problems(captured_todo("rgbd slice", slice_problems)
                  + captured_todo("stereo bench", stereo_problems)
                  + captured_todo("stereo kitti", kitti_problems) + later,
                  rows)
    check_k2_per_view(by_phase)
    check_k5_per_pair(by_phase)
    check_k4_per_solve(by_phase)
    log("K7 (the match tail) launches per frame by phase: "
        f"{ {p: per_frame(c, 'match_tail') for p, c in by_phase.items()} }")
    log(f"K4 accept test: over {ACCEPT_TEST['solves']} held solves, "
        f"{ACCEPT_TEST['f32_differs']} of {ACCEPT_TEST['iterations']} "
        f"iterations where a float32 comparison of the two chi2s parts from "
        f"the float64 one the kernel takes")
    for row in rows:
        if "variant_key" in row:
            # a variant's path is phase 18's
            key = row["variant_key"]
            row["launches"] = by_phase["18 beyond"][key]
            row["launches_by_phase"] = {p: c[key] for p, c in by_phase.items()}
            continue
        # the newest slice's main path is phase 16c's street circuit;
        # every other path's count is listed beside it. Each phase has
        # failed already if a kernel of its path was not launched (phase 10
        # keeps one keyframe over its 30 frames, so no duplicate-landmark
        # merge and no distance_matrix there).
        key = row["name"].removeprefix("hamming_")
        row["launches"] = by_phase["16c street"][key]
        row["launches_by_phase"] = {p: c[key] for p, c in by_phase.items()}
        row["launches_per_frame_by_phase"] = {
            p: per_frame(c, key) for p, c in by_phase.items()}
    log("pose_lm launches per frame by phase: "
        f"{rows[2]['launches_per_frame_by_phase']}")
    log(f"the whole run took {time.perf_counter() - t_run:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
