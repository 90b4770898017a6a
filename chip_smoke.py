"""Drive the PyTorch/CUDA port's render paths once on one GPU: the
forward render and the differentiable forward + backward (fused, unfused
and through the generic bounce), on the Cornell box, on a mesh of the
Stanford bunny's size, on rich-textured scenes, on scenes with
constant-density media, on ellipsoids, on demo2 (the reference's
"everything at once" scene) and on a 523,264-triangle mesh loaded from an
.obj file, and the bounded-depth ``grad_render``; and which engine serves
each route (``engine_report``); the scene drivers and the parity script
(``raytrace_tpu_torch/scenes``); the sharded render and train step at
one rank over NCCL and over two processes on the one card
(``raytrace_tpu_torch/parallel``); and the forward drivers' own counts
of iterations and path segments (``with_stats``).

Run from the repository root:  python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels of raytrace_tpu_torch/csrc with nvcc;
3. kernel A (bounce) against its plain PyTorch version on the card, with
   the tables prepared as the drivers launch them: the Cornell box at the
   main path's shapes (600 x 600 camera rays on 360,064 lanes, then their
   second bounce) through the planar instantiation, the camera rays once
   more through the general one, and Cornell and an all-materials scene
   (the general instantiation), with and without redirect targets, on
   2^16 random lanes;
4. kernel B (iteration) against its plain version at the main path's
   shapes (360,064 lanes, width 600), prepared as the drivers launch it:
   its planar instantiation on the Cornell box, the general one on the
   all-materials scene (with and without redirect targets) and on the
   box/motion scene, each exact and with Russian roulette: one iteration
   from a random lane state, then 30 from a fresh one (the summed
   radiance's max |err| printed);
5. the main path, ``render_accumulate`` on the Cornell box at 600 x 600,
   depth 50, at 64 spp (bench.py's 200 cut to keep the smoke short) —
   exact estimator and Russian roulette from depth 2 (stationary driver,
   rotate_k 8: kernel B's rotated mode, every launch through its planar
   instantiation);
6. the main path at spp 1 (rotate_k 1: the fused branch, kernel B, every
   launch through its planar instantiation); then the same path at 16
   spp (rotated as at 64: k_rot 8, two samples a chunk), 2 spp (k_rot 2,
   one a chunk) and 1 spp once more, with every kernel launch (the
   rotated mode's accumulation planes too) held against its plain
   version on the inputs the driver gave it;
7. each kernel's device time per launch (torch.profiler) and its
   wrapper's call back to back (CUDA events: the host's cost) beside its
   plain version's at the main path's 360,064 lanes; kernels A's and B's
   times also through their general instantiation (unprepared: B's host
   time too) and with ``n_prims=0`` (the shade and the lane I/O alone),
   their ``-Xptxas -v`` reports and B's SASS loops; kernel B's rotated
   mode at the main path's k_rot 8 and spp_k 8, its lanes spread over
   every chunk, checked against its plain version, timed and bounded;
8. the backward kernel K5 against its plain version (torch autograd over
   ``lane_math``) on 2^18 lanes of a real mid-render state (kernel B
   steps the fwd+bwd configuration four times; random cotangents): the
   Cornell box, the all-materials scene and the box/motion scene, with 0
   and 2 redirect targets, and 2^17 lanes of the bunny stand-in's fused
   mesh state; per state the per-lane mode lane by lane, then the
   reduced mode (rows read by index, row gradients summed in the launch:
   the mode every fwd+bwd runs, staged or global as its table's size
   picks) against its plain version and its per-lane mode;
9. ``render_loss_wavefront``'s value and gradient at 2^14 lanes, 8 spp,
   40 iterations, with K5 and with the backward forced to its plain
   version: equal losses, gradients within ``GRAD_RTOL``;
10. the second main path: the fwd+bwd of ``bench.py`` (Cornell 600 x
    600, depth 50, RR from depth 2, 2^18 lanes x 64 spp, 205 iterations
    then 25 at 2^14 and 100 at 2^12 lanes) after one warm-up run: wall,
    primary rays/s, loss, samples completed, launches of kernel B (every
    one planar) and of K5's reduced and per-lane modes (the per-lane one
    never), peak memory;
11. central finite differences of the loss on the card (2^14 lanes,
    exact estimator, same seed) for the light's emission and the red
    wall's albedo against their gradients;
12. K5's time at 2^18 lanes: the reduced mode's device time (its kernel
    and the two finishing launches) and host time, its plain version's,
    its bound, and the per-lane mode's device time alone and with the
    torch gather and ``index_add_`` it replaced; then phase 10's fwd+bwd
    with the per-lane backward and with the reduced one in turns (per
    lane, reduced, reduced, per lane): walls, peaks, device time per
    iteration, and the index ops inside the backward steps (none in the
    reduced runs).

The mesh scale (``testing.bunny_standin_scene``: 4,968 triangles in 4,992
rows, the bunny scene's material, camera, gray fade and depth 10):

13. the nearest-hit kernel (BVH walk) against its plain all-pairs version
    on every lane: 2^17 camera rays of the stand-in at 600 x 600 and their
    second bounce, the same on the mixed-kind mesh scene (still and with
    its extras moving), and 2^14 rays on a 50,000-triangle sphere; the
    BVH build times, and ``pack_bvh``'s (the binned-SAH tree) beside
    ``build_bvh``'s (the median split of the rows' order) over the same
    boxes at 4,992 and 50,048 rows;
14. the shade kernel against its plain version on those hit records, with
    and without a synthetic medium;
15. kernel B's mesh variant against its plain version on 2^17 lanes of
    the stand-in, exact and with Russian roulette, one iteration from a
    random state and 10 from a fresh one;
16. route 1, the split forward: ``render_accumulate`` of the stand-in at
    600 x 600, depth 10, 16 spp, exact and with RR from depth 2 (the
    nearest and shade kernels once per iteration, kernel A never); then
    the same at 1 spp with every launch held against its plain version;
17. route 2, the mesh fwd+bwd of ``tools/prof_bunny_grad.py``
    (``testing.MESH_FWD_BWD``: 2^17 lanes x 16 spp, 30 iterations then
    12 at 2^15 and 30 at 2^13 lanes; 72 launches each of the mesh variant
    and the reduced K5, none of the per-lane one) after one warm-up; at 2^14 lanes the fwd+bwd with every
    kernel against the one with every plain version; a finite difference
    of the mesh's albedo;
18. the three mesh kernels' device and host times at the slice's shapes
    beside their plain versions' and their bounds (the BVH's operation
    count from the box tests and row tests of each ray, counted by the
    kernel, printed for all rays and for the rays that hit), and the
    compiler's register, stack and spill report of the two walks'
    kernels (``-Xptxas -v``).

Rich textures (image, noise, marble):

19. the flat-scan nearest kernel K8 and the marble kernel K12 against
    their plain versions on every lane of ``scenes/noise_test.py``'s
    90,112 camera lanes at 400 x 225 and their second bounce (the ball's
    hit points with their texture ids), both held to equality; K12 also
    on the lanes the route hands it (the rich lanes compacted by
    ``torch.nonzero``) and on ``testing.marble_patterns`` (alternating,
    all marble, none, a ragged count, 32 shuffled rows with a repeated
    id);
20. route 3, the rich forward: ``render_accumulate`` of noise_test at
    400 x 225, 100 spp, depth 50, seed 0 (the stationary driver, rotate_k
    5: K8, the shade kernel and K12 every iteration, kernels A and B
    never), written to chiprun_out/noise_test.png; then a 1 spp render
    with every launch held against its plain version;
21. route 4, ``tools/prof_texture_grad.py``'s image-textured fwd+bwd
    (2^17 lanes x 16 spp, 80 iterations, RR from depth 2; the atlas
    gradient K13 once per iteration but the last, whose multiply feeds no
    later radiance) after one warm-up; the same again with every K13
    launch held against its plain version; at 2^14 lanes the fwd+bwd with
    every kernel against the one with every plain version; a finite
    difference of an atlas texel;
22. the textured bunny stand-in's fwd+bwd (``tools/prof_bunny_tex.py``'s
    image on the stand-in, ``testing.MESH_FWD_BWD``);
23. K8's, K12's and K13's times at those shapes (device time per launch
    from torch.profiler: each is shorter than its wrapper's host cost,
    which back-to-back CUDA events would time; those are printed too)
    beside their plain versions', their bounds and, for K13,
    ``index_put_``'s; K12's SASS instruction counts (its fast path, a
    marble lane's) and registers.

Constant-density media (``testing.cornell_smoke_scene``: the Cornell box
with two smoke blocks of 6 boundary rows each; ``testing.pawn_standin_scene``:
a 1,200-triangle procedural pawn used as a glass shell and as the boundary
of a red medium):

24. the crossing kernels against their plain version on every lane: K11
    on cornell_smoke's 360,064 camera rays at 600 x 600 and their second
    bounce (which starts inside both smoke blocks), in its planar
    instantiation (the route's), its general one prepared and unprepared,
    K11b (the walk of a per-medium BVH forest) on 2^17 camera rays of the
    pawn stand-in, their second bounce and 2^17 rays from inside its
    medium, K11 on 2^16 random rays of ``tests/test_volume_kernel.py``'s
    fog ball and smoke box (a box row), and K11b on 2^16 random rays of
    ``testing.mixed_media_world``'s four media of mixed sizes in one
    1,266-row boundary, each still and moving; every line must say 0
    differing lanes and max |err| 0; on the same rays, with draws of the
    scatter columns (0 on every 7th lane), the candidate mode of K11 (both
    instantiations) and K11b through ``render/volumes.py:medium_hit``
    against its plain version: the material id and scattering equal on
    every lane, t_med within ``testing.CAND_ULPS`` ulps;
25. route 5, the media forward: ``render_accumulate`` of cornell_smoke at
    600 x 600, depth 50, seed 0, at ``FWD_SPP`` (the scene's 200 cut):
    the stationary driver at rotate_k 8, K8, K11 (planar, in the
    candidate mode: every launch) and the shade kernel every iteration,
    kernels A and B never; written to
    chiprun_out/cornell_smoke.png; then a 1 spp render with every launch
    held against its plain version;
26. route 6, the mesh-boundary medium: the pawn stand-in at 500 x 500,
    depth 20, ``PAWN_SPP`` (the scene's 400 cut) through the sorted
    driver (K9, K11b and the shade kernel every iteration), written to
    chiprun_out/pawn_standin.png; then a checked 128 x 128 render at 1
    spp;
27. phase 13's 50,000-triangle sphere through the sorted driver at 256 x
    256, 4 spp, depth 10 (a stationary render of 8,192 rows and more,
    which raised before the sorted driver);
28. K11's and K11b's times at those shapes beside their plain versions',
    their bounds and their launches: K11 in the route's candidate mode
    through ``medium_hit`` and in the crossings mode, planar, general and
    unprepared, its registers and the SASS instructions of each
    instantiation's row loop (a ray and row: the operations of its
    bound); K11b also in the candidate mode, its box tests and row tests
    a ray (counted by the kernel) for the camera rays and the rays from
    inside, the bound of that work, and the bound of the 256-row chunk
    scan it replaced at that scan's work.

The unfused differentiable wavefront (``trace_wavefront_diff`` with
``rotate_k > 1`` or ``pixel_cost``: torch glue around kernel A forward and
the replay backward K7 in every iteration) and F8's media groups:

29. K7 against its plain version on 2^18 lanes of the unfused driver's
    mid-render states (``testing.k7_inputs``: kernel A steps the lanes
    four times), on phase 8's scenes and targets and a 384-row mixed-kind
    mesh (the global mode), within ``testing.BWD_RTOL``, then its reduced
    mode as K5's in phase 8;
30. route 8, ``tools/prof_diff_rot.py``'s configuration
    (``testing.FWD_BWD_ROT8``: bench.py's Cornell fwd+bwd at 2^18 lanes x
    64 spp with rotate_k 8, 195 iterations, no remat) after one warm-up:
    wall, primary rays/s, loss, samples completed, launches of kernel A
    and the reduced K7 (each once per iteration; the per-lane K7 never),
    peak memory;
31. route 9, ``tools/prof_completion.py``'s (``testing.FWD_BWD_BAL4``:
    rotate_k 4 balanced by ``lane_cost_estimate(spp_est=4)``, which runs
    inside the timed region, 184 iterations), printing the same; then
    route 8 with ``remat=True`` (each iteration checkpointed), its peak
    memory beside route 8's; then route 8 with the per-lane backward and
    the reduced one in turns, as phase 12 does phase 10;
32. at 2^14 lanes: the unfused fwd+bwd with K7 against the same with
    K7's plain version (equal losses, gradients within ``GRAD_RTOL``);
    rotate_k 2 against the fused rotate_k 1 where every sample completes
    (the loss within 1e-4, the gradients within ``GRAD_RTOL``, the lanes
    the two resolve differently counted); a central finite difference of
    the red wall's albedo through the unfused route;
33. scenes of 17 media (``testing.many_media_world``, 400 x 400, 4 spp:
    fog balls and boxes through K11, and rotated boxes, a 102-row
    boundary, through K11b) rendered with every candidate-mode launch (two
    a bounce: 16 media, then 1, the second folding into the first's rows)
    held against its plain version;
34. K7's times at 2^18 lanes, as K5's in phase 12.

The generic bounce (``integrator.bounce_generic_soa``: the forward of the
scenes kernel A and the split path refuse, the differentiable route of
media and of every scene the fused step and kernel A refuse) and the
bounded-depth path (``trace``, ``render_tile``, ``grad_render``):

35. the keyed mode of the crossing kernels (the crossings and, per
    medium, the keys of the candidates they came from, which the
    differentiable backward reads) against its plain version on every
    lane: K11 planar and general on cornell_smoke's 360,064 camera rays,
    K11 on phase 24's 2^16 random rays through the fog ball and smoke box,
    still and moving, and K11b on 2^17 camera rays of the pawn stand-in
    and 2^17 rays from inside its medium: flags and keys equal on every
    lane, crossings max |err| 0 and equal to the crossings mode's; then
    the keyed mode's device and host times beside the crossings mode's,
    in turns, its plain version's and its bound;
36. the media fwd+bwd at full size (``testing.SMOKE_FWD_BWD``:
    ``loss_and_grads`` on cornell_smoke at 600 x 600, depth 50, RR from
    depth 2, 2^18 lanes x 16 spp, remat, 100 iterations then 40 at 2^14
    and 100 at 2^12 lanes) after one warm-up: wall, primary rays/s,
    samples completed (>= 0.999), device time, device ops an iteration,
    peak memory, launches (K8 and the keyed K11, none of kernels A, B or
    the shade kernel), finite gradients and a non-zero density gradient;
    at 2^14 lanes x 4 spp every K8 and keyed K11 launch against its plain
    version (0 lanes differing, max |err| 0), and the run against the one
    with every plain version (``testing.plain_kernels``: the loss within
    1e-6 relative, each gradient leaf within ``GRAD_RTOL`` in the L2
    norm: the backward's index adds are atomics);
37. the mesh-boundary media fwd+bwd (``testing.PAWN_FWD_BWD``: the pawn
    stand-in at 500 x 500, depth 20, 2^17 lanes x 4 spp): K9 and the
    keyed K11b, finite gradients, and every launch of a 2^13-lane run
    against its plain version;
38. the generic route on the Cornell box (``use_mega=False``) against the
    fused route, the same seed, 2^16 lanes x 8 spp, 70 iterations: the
    loss within 1e-3 and every gradient leaf within 5% in the L2 norm
    (the same estimator; a path that resolves a hit differently moves a
    leaf), K8 launched and kernels A and B never;
39. the generic forward: ``testing.marble_light_scene`` (a light with a
    marble texture: K8 and K12) and ``testing.nine_target_scene``
    (cornell_smoke with nine redirect targets: K8 and K11's candidate
    mode) at 400 x 400, 16 spp, depth 50, written to
    chiprun_out/marble_light.png and nine_targets.png, each with a
    checked 64 x 64 render at 2 spp (every launch against its plain
    version);
40. ``grad_render`` on cornell_smoke at 600 x 600, depth 50, over a tile
    of 2^16 pixels x 4 samples (``testing.SMOKE_GRAD_RENDER``): wall,
    peak memory, finite gradients; and the JAX package's fog-sphere
    density check (``tests/test_gradients.py:393-418``) on the card:
    the score-function gradient averaged over 4 seeds against a central
    difference at +-0.15 over 6 seeds, both below -0.05, rtol 0.35.

The rest of M11 (rotated sphere instances' object-space uv, ellipsoids,
demo2: ``testing.demo2_scene``, ``scenes/demo2.py``'s world):

41. K10 with its rotation table (``shade_megakernel(sphere_rots=...)``)
    on 600 x 600 camera rays of ``testing.rotated_spheres_scene`` (32 of
    64 checker spheres rotated), sphere flag 1 on every sphere lane and
    ellipsoid winner indices on a third of the missing lanes, against
    ``shade_plain`` with the same rotations (exact rows equal, max |err|
    0), with and without a synthetic medium; the table must change the
    checker cell of rotated lanes only; its time against the same launch
    with an empty table, in turns, its plain version's and its bound;
42. ``testing.ellipsoid_scene`` (the Cornell box and three ellipsoids:
    scaled and rotated, earth-textured, moving) at 600 x 600, 16 spp,
    depth 50 through the split route (K8, the ellipsoids merged in
    torch, K10, the earth's image multiplied in), written to
    chiprun_out/ellipsoids.png, with a profiled 2 spp run (device time
    and ops an iteration, busy share) and a checked 128 x 128 render at 1
    spp (every K8 and K10 launch exact);
43. its ``grad_render`` through the generic differentiable bounce at
    2^16 pixels spread evenly over the image x 4 samples
    (``testing.DEMO2_GRAD``): every ellipsoid
    leaf finite; at 2^12 pixels x 2 samples every K8 launch against its
    plain version and the run against the one with every plain version
    (``testing.plain_kernels``: the loss within 1e-6 relative, every leaf
    within ``GRAD_RTOL`` in the L2 norm); d(mean hit t)/d(radius) of each
    ellipsoid, over the camera rays whose winner it stays at r +- eps,
    against a central difference (rtol 0.02);
44. demo2 at its own settings (400 x 400, ``DEMO2_FWD_SPP`` spp, depth 4,
    seed 1234) through ``render_accumulate``: the split route (K9 over
    1,536 rows, K11's candidate mode for the fog and the blue medium,
    K10, K12 and the earth's image multiplied in): wall, primary rays/s,
    iterations, launches, peak memory, chiprun_out/demo2.png, a profiled
    8 spp run, and a checked 400 x 400 render at 1 spp (every K9, K11,
    K10 and K12 launch exact);
45. demo2's ``grad_render`` at 2^16 pixels x 4 samples with respect to
    every float leaf (K9, the keyed K11, K13): finite, a fog density and
    texel gradient; at 2^12 x 2 every K9, keyed K11 and K13 launch
    against its plain version and the run against the plain one, as in
    phase 43; the fog density's score-function gradient (4 seeds) against
    a central difference at +-30% (6 seeds) over 2^14 pixels x 4
    samples, within rtol 0.35 or 3 standard errors and beyond 3 standard
    errors of 0.  The blue medium's gradient is printed: at depth 4 no
    path that scatters in it reaches the light (its radiance and gradient
    are 0 in both packages, ``tests/test_torch_demo2.py``).
46. bigmesh-512 (``tools/bench_bigmesh.py`` at 512 x 512 cells: 523,264
    triangles, ``testing.BIGMESH``): the mesh as .obj text written to a
    temporary file and read back by the native parser (``csrc/
    objparse.cpp``, built with g++; raises if it does not build), equal
    to the Python parser's mesh and to the numbers written, both timed;
    compiled on the card (523,328 kind-segmented rows), and the split
    path's BVH: ``pack_bvh``'s seconds, depth, nodes and bytes;
47. K9 over those rows against its plain version on a fixed sample of
    ``BIG["k9_sample"]`` lanes of the 262,144 camera rays and of their
    second bounce (exact), its device and call times, the box tests and
    row tests a ray, and its bound;
48. the forward at the tool's settings (512 x 512, 16 spp, depth 8)
    through ``render_accumulate``: the sorted driver, the split path, K9
    and K10 and no other kernel (wall, ``pack_bvh``'s share, iterations,
    peak memory, chiprun_out/bigmesh.png), a profiled run, and a checked
    1 spp render (every K9 launch on the sample, every K10 launch whole,
    exact);
49. ``grad_render`` on 2^16 pixels spread over the image x 4 samples
    (``testing.BIGMESH_GRAD``) to every leaf: finite, the mesh rows' e1
    and e2 and the albedos non-zero (p0's is zero, in the JAX package
    too: a lambertian hit's weight does not depend on the hit point); at ``BIG["checked_pixels"]`` every
    K9 launch against its plain version, the run against the one with
    every plain version (loss within 1e-6 relative, leaves within
    ``GRAD_RTOL``), and d loss / d the mesh's albedo against a central
    difference (``FD_RTOL``);
50. ``utils/engines.py:engine_report`` at the settings of every route the
    smoke drives, held against the launch counters and the driver of a
    run that takes the same route (a smaller one whose report is the
    route's, or phases 48 and 49's runs);
51. the scene drivers of the reference's scenes that phases 1-50 do not
    render (``raytrace_tpu_torch/scenes``: cornell_box, quad_test,
    metal_test, readme_example, lommel_seeliger_test, sphere_uv_test,
    demo1), each through its
    ``build`` at its own width and depth with the samples cut
    (``SCENE_SPP``): wall, primary rays/s, launches (kernel B; K8 for
    sphere_uv_test's one-lane queue, the generic bounce), PNGs in
    chiprun_out/; then a checked render of each at 1 spp
    (``SCENE_CHECKED_WIDTH``: the work queue on kernel A), every launch
    exact;
52. ``scenes/parity.py`` at the reference's configurations of cornell_box
    (600 px, 200 spp, depth 50, redirection) and readme_example (600 px,
    50 spp): each mean brightness within 1% of the reference's mean that
    PARITY.md records, and the PNG verdict (``NO_REFERENCE`` without the
    reference's PNGs);
53. ``parallel/`` at one rank over NCCL (``multihost.initialize`` with
    explicit arguments): ``sharded_wavefront_render_fn`` on Cornell 600 x
    600, 64 spp, depth 50, bit-equal to ``render_accumulate``;
    ``sharded_render_fn`` on 2^16 pixels x 8 samples, bit-equal to
    ``render_tile``; ``sharded_train_step_fn`` with Adam, 5 steps of
    bench.py's fwd+bwd (2^18 lanes x 64 spp, 205 iterations, no schedule)
    toward a target rendered with the red wall's albedo moved by 0.2: the
    loss falling, the albedo moving, launches of B and K5 (per lane 0),
    peak memory; ``entry.dryrun_multichip(1)``;
54. two processes on cuda:0 over gloo (``python -m
    raytrace_tpu_torch.parallel.worker``; NCCL refuses two ranks on one
    device): ``multihost.render`` of Cornell 128 x 128, 16 spp, bit-equal
    to the same two pixel blocks rendered in this process and within atol
    2e-5, rtol 1e-5 of one rank's image, and one train step's loss and
    every gradient leaf within ``GRAD_RTOL`` of one rank's; each worker's
    failure or the phase's time limit fails it.

55. the forward drivers' ``with_stats`` (``render/integrator.py``): the
    stationary driver on Cornell 600 x 600 at 8 spp, rotate_k 8 (kernel
    B's rotated mode) and at 1 spp (kernel B), the sorted driver on the pawn
    stand-in at 500 x 500, 2 spp (K9, K11b, K10) and the work queue on
    Cornell 600 x 600, 1 spp, 2^16 lanes (kernel A), each at depth 50
    (the pawn 20): the iterations equal to the launches of the route's
    per-iteration kernels in that call, ``lanes x iterations >= segments
    >= n_pix x spp``, and the image bit-equal to the same call without
    the flag; the counts, the occupancy and the ms an iteration printed.
    (The queue at 1 spp and the sorted driver at 2 spp add at most two
    paths into a pixel, so their sums do not depend on the order in
    which ``index_add_``'s atomics land; at more samples two runs of
    either driver can differ in the last bits, with or without the
    flag.)

56. the sorted driver's turn (``ops/sorted_turn.py``: HEAD and TAIL,
    ``csrc/sorted_turn.cu``) at pawn-fwd's shapes (the pawn stand-in 500 x
    500, 250,112 lanes, 15 uniform columns): every launch of a 2-spp
    render against the plain versions (``testing.sorted_turn_checks``:
    exact but for the radiance sums' atomics, and launches of every state
    of the queue), the device and host ms of each on a middle turn beside
    its bound (bytes), and a 4-spp render's host launches a turn (at most
    80) and ms a turn against the plain versions', in turns.

Then a JSON line of the kernels, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  The rendered images go to
chiprun_out/.  Tolerances (``raytrace_tpu_torch/testing.py``): exact rows
equal on every lane, floats within atol 2e-3 + rtol 1e-3 (the mesh
kernels, K8, K12, K11 and K11b, built like the plain versions'
arithmetic, are held to equality: a max |err| of 0); K5 within ``testing.BWD_RTOL`` of each
gradient's scale (the hand-derived adjoint sums the chain-rule terms in
another order than autograd); K13 within ``testing.image_grad_errs`` of
its plain version and of a float64 sum (float atomics add in a varying
order); the reduced K5 and K7: lane outputs equal to the per-lane mode's,
each table entry within ``n * 2^-23 * sum |g|`` of the float64 sum of
the per-lane mode's row gradients, and within that plus the per-lane
tolerances of the plain version's (``testing.compare_reduced``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
# fwd+bwd with K5 vs with its plain backward: per gradient leaf, the
# largest difference within GRAD_RTOL of the leaf's largest value (K5's
# per-lane differences, summed by atomic index_add_ in a run-dependent
# order)
GRAD_RTOL = 1e-3
# finite differences: relative tolerance (the loss is a polynomial in an
# emission or an albedo under the exact estimator; f32 rounding of the
# loss and the step's curvature are far below it)
FD_RTOL = 0.02
# samples per pixel of the forward main path (bench.py renders 200)
FWD_SPP = 64
# samples per pixel of phase 6's checked renders that rotate as the main
# path does: rotate_k_for gives 8, so each chunk spans 2 samples
CHECKED_ROT_SPP = 16
# the card's published peaks (H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# samples per pixel of the mesh forward main path (scenes/bunny_test.py
# renders 100)
MESH_SPP = 16
# float operations of the BVH walk (csrc/bvh_nearest.cuh): a box's slab
# test (two a node) and a triangle row's test, counted from the sources
BOX_OPS = 30
ROW_OPS = 45
# instructions of one marble lane: the fast path of the stripe computed
# by one thread, its 8 corners unrolled in a loop of 7 octaves (the
# kernel's earlier one-thread-a-lane form over csrc/noise.cuh), in the
# SASS of its sm_90a build (cuobjdump -sass, fast_path_count): 848 for the lane's stripe with one
# octave and 798 for each of the 6 more, the lane's load, match and store
# ~70 (a count from the source, 4,600, missed the avalanches, the
# conversions and the range reductions); each instruction taken as one
# operation at the float32 rate
MARBLE_OPS = 5700
# samples per pixel of the mesh-boundary medium's forward
# (scenes/pawn_test.py renders 400)
PAWN_SPP = 16
# float operations of the crossing kernels (csrc/volume.cuh): a boundary
# row's roots (sphere, plane or box, ~40) and its two folds (~10 each),
# and one chunk-box test of K11b (~20), counted from the source
VOL_ROW_OPS = 60
VOL_BOX_OPS = 20
# the rows a camera ray of the pawn stand-in tested in the 256-row chunk
# scan that K11b's forest walk replaced, as that kernel counted them on an
# NVIDIA H100 (PERF.md section 6)
CHUNK_ROWS_A_RAY = 209.39
# the sizes of phases 35-40 beside the testing configurations they take:
# the pawn stand-in's rays, phase 24's random rays through the fog ball
# and box, the checked runs' lanes, phase 38's Cornell lanes, phase 39's
# renders and their checked renders' width
GENERIC = dict(pawn_rays=1 << 17, fog_rays=1 << 16, checked_lanes=1 << 14,
               pawn_checked_lanes=1 << 13, cornell_lanes=1 << 16,
               cornell_iters=70, width=600, pawn_width=500,
               forward_width=400, forward_spp=16, checked_width=64)


def _smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time in ms of ``fn``'s calls back to back, between CUDA events
    (after ``warmup`` calls): the larger of its host cost and its device
    time."""
    import torch
    for _ in range(warmup):
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


def _device_ms(fn, kernel, reps: int) -> float:
    """Mean device time in ms of one call of ``fn``'s launches of
    ``kernel`` (a substring of a kernel's name, or a tuple of them: the
    means of each summed) over ``reps`` calls, read from torch.profiler:
    a kernel shorter than its wrapper's host cost leaves the card idle
    between back-to-back launches, so CUDA events around them would time
    the host instead.  The profiler's device trace can drop some events
    of a burst of microsecond launches (31 of 50 seen on an H100), so each
    mean is over the launches it recorded, at least one a name; a session
    that recorded none of a name (seen on an H100 after several long
    sessions in one process) is run again, up to three times, and if
    none records it, a lone ``kernel`` is timed by CUDA events around
    ``reps`` calls (the larger of the host cost and the device time: an
    upper bound, said on stdout)."""
    import torch
    from torch.autograd import DeviceType
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {name: [e.time_range.end - e.time_range.start
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA and name in e.name]
              for name in names}
        if all(us.values()):
            break
    else:
        if len(names) == 1 and not us[names[0]]:
            ms = _time_ms(fn, reps, 0)
            print(f"_device_ms: torch.profiler recorded no launch of "
                  f"{names[0]} in 3 sessions; CUDA events: {ms:.4f} ms a "
                  f"call", flush=True)
            return ms
    total = 0.0
    for name in names:
        if not 0 < len(us[name]) <= reps:
            raise AssertionError(f"{name}: {len(us[name])} profiled launches "
                                 f"of {reps}")
        total += sum(us[name]) / len(us[name]) / 1e3
    return total


def _device_ops(prof) -> dict:
    """``{name: [count, device us]}`` over the device-side events of a
    profile."""
    from torch.autograd import DeviceType
    ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            op = ops.setdefault(e.name, [0, 0.0])
            op[0] += 1
            op[1] += e.time_range.end - e.time_range.start
    return ops


def ptxas_report(names=("nearest_kernel", "iter_kernel")) -> list[str]:
    """The ``-Xptxas -v`` lines (registers, stack frame, spills) of the
    kernels whose mangled names contain one of ``names``, from the
    build's log."""
    from raytrace_tpu_torch.ops._build import BUILD_DIR
    out, entry = [], None
    for line in (BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
            entry = name if any(n in name for n in names) else None
        elif entry is not None and ("stack frame" in line
                                    or "Used " in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def sass_text(stem: str) -> str | None:
    """``cuobjdump -sass`` of the build's object of ``csrc/<stem>.cu``, or
    None without the object or the tool."""
    from raytrace_tpu_torch.ops._build import BUILD_DIR
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    objs = sorted(BUILD_DIR.glob(f"{stem}_*.o"))
    if not objs or not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(objs[-1])], capture_output=True,
                          text=True, check=True).stdout


_BRA = re.compile(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)")
# what marks a slow path in SASS: a call (the IEEE division's and sqrt's),
# local memory, the constant table of the trigonometric functions'
# Payne-Hanek reduction, a double multiply
_SLOW = ("CALL", "LDL", "STL", "LDG.E.CONSTANT", "DMUL")


def sass_functions(stem: str) -> dict:
    """``{kernel name: [(address, instruction), ...]}`` of the build's
    object of ``csrc/<stem>.cu`` (empty without the object or
    cuobjdump)."""
    sass = sass_text(stem)
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass or "")[1:]:
        out[fn.split("\n", 1)[0].strip()] = [
            (int(a, 16), op) for a, op in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    return out


def _sass_loop_spans(ins) -> list[tuple[int, int]]:
    """``(first, last)`` address of each loop: each backward branch and
    its target."""
    spans = []
    for addr, op in ins:
        m = _BRA.search(op)
        if m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    return spans


def fast_path_count(ins, lo: int, hi: int) -> int:
    """The instructions of ``ins`` in ``[lo, hi]`` that a thread runs on
    the fast path: those outside every predicated forward branch's span
    that holds a slow-path instruction (``_SLOW``)."""
    skip = []
    for addr, op in ins:
        m = _BRA.search(op)
        if lo <= addr <= hi and m and op.lstrip().startswith("@") \
                and int(m.group(1), 16) > addr:
            end = int(m.group(1), 16)
            if any(s in o for a, o in ins if addr < a < end for s in _SLOW):
                skip.append((addr, end))
    return sum(1 for a, _ in ins if lo <= a <= hi
               and not any(s < a < e for s, e in skip))


def sass_loops(stem: str = "bounce_kernel") -> list[str]:
    """For each kernel of ``csrc/<stem>.cu``: its SASS instruction count
    and, for each backward branch (a loop), the span it closes, its
    instruction count and whether it holds a call (the IEEE division's
    slow path) -- from ``cuobjdump -sass`` of the build's object."""
    fns = sass_functions(stem)
    if not fns:
        return [f"no object of {stem} or no cuobjdump"]
    out = []
    for name, ins in fns.items():
        loops = []
        for lo, addr in _sass_loop_spans(ins):
            body = [o for a, o in ins if lo <= a <= addr]
            call = any("CALL" in o for o in body)
            loops.append(f"[{lo:#x}, {addr:#x}] {len(body)} instructions"
                         f"{' with a CALL' if call else ''}")
        out.append(f"{name}: {len(ins)} instructions; loops: "
                   f"{'; '.join(loops) or 'none'}")
    return out


def inner_loop_sizes(stem: str, name: str,
                     op: str = "LDS") -> list[tuple[str, int]]:
    """``(kernel, instructions)`` of the innermost loop that issues an
    ``op`` instruction (the shortest such backward branch's span; by
    default a shared-memory load, so a scan's row loop and not its
    staging loop) of each kernel of ``csrc/<stem>.cu`` whose mangled name
    contains ``name``."""
    out = []
    for fn, ins in sass_functions(stem).items():
        spans = [(lo, hi) for lo, hi in _sass_loop_spans(ins)
                 if any(o.split()[0 if not o.startswith("@") else 1]
                        .startswith(op) for a, o in ins if lo <= a <= hi)]
        if name in fn and spans:
            lo, hi = min(spans, key=lambda sp: sp[1] - sp[0])
            out.append((fn, sum(1 for a, _ in ins if lo <= a <= hi)))
    return out


def source_constant(stem: str, name: str) -> int:
    """The value of ``constexpr int <name>`` in ``csrc/<stem>.cu``."""
    from raytrace_tpu_torch.ops._build import CSRC
    src = (CSRC / f"{stem}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _device_total_ms(fn, reps: int) -> float:
    """Device time in ms of all of one call's launches (``fn`` run
    ``reps`` times under torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / reps / 1e3


# the CPU ops that gather or scatter by an index, and the autograd nodes of
# the two backward kernels' steps
INDEX_OPS = ("aten::index_add_", "aten::index_add", "aten::index",
             "aten::index_select", "aten::gather", "aten::take",
             "aten::index_put_", "aten::scatter_add_")
BWD_NODES = ("_FusedLoopBackward", "_MegaBounceBackward")


def _profile_fwd_bwd(fn, iters: int) -> dict:
    """One call of ``fn`` (a fwd+bwd of ``iters`` iterations) under
    torch.profiler: its device time per iteration in ms and the index ops
    run inside the backward steps of K5 and K7 (``{op name: count}``)."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = 0.0
    index_ops = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_us += e.time_range.end - e.time_range.start
        elif e.name in INDEX_OPS:
            p = e.cpu_parent
            while p is not None and not any(n in p.name for n in BWD_NODES):
                p = p.cpu_parent
            if p is not None:
                index_ops[e.name] = index_ops.get(e.name, 0) + 1
    return dict(device_ms_per_iter=dev_us / 1e3 / iters,
                backward_index_ops=index_ops)


def _check(label: str, errs, lanes: int) -> float:
    """Print one kernel-vs-plain comparison, raise if it is out of
    tolerance, return its max abs error."""
    from raytrace_tpu_torch.testing import ATOL, RTOL
    n_int, err, excess = errs
    print(f"[{label}] {lanes} lanes: exact rows differ on {n_int} lanes, "
          f"max |err| {err:.3g} (atol {ATOL} rtol {RTOL}, worst excess "
          f"{excess:.3g})", flush=True)
    if n_int or excess > 0:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             "version")
    return err


def _check_reduced(label: str, args, kw, tables) -> float:
    """Print one reduced K5 or K7 against its plain version and its
    per-lane mode (``testing.compare_reduced``), raise if out of
    tolerance, return its max abs error."""
    import torch
    from raytrace_tpu_torch.ops.row_reduce import STAGED, row_mode
    from raytrace_tpu_torch.testing import compare_reduced
    r = compare_reduced(args, kw, tables)
    torch.cuda.synchronize()
    mode = ("staged" if row_mode(tables.n_prims, kw["n_row"]) == STAGED
            else "global")
    print(f"[{label}] {tables.n_prims} rows, {mode} mode: lane outputs max "
          f"|err| {r['lane_err']:.3g}, worst excess {r['lane_excess']:.3g} "
          f"(BWD_RTOL), {r['lane_differ']} differ from the per-lane mode's; "
          f"tables max |err| {r['rows_err']:.3g} against the float64 sum of "
          f"the per-lane mode's rows (worst excess {r['rows_excess']:.3g} "
          f"over n*2^-23*sum|g|), {r['plain_err']:.3g} against the plain "
          f"version's (worst excess {r['plain_excess']:.3g} over that plus "
          "the lanes' tolerances)", flush=True)
    if (not r["lane_excess"] <= 0.0 or r["lane_differ"]
            or not r["rows_excess"] <= 0.0 or not r["plain_excess"] <= 0.0):
        raise AssertionError(f"{label}: out of tolerance")
    return max(r["lane_err"], r["plain_err"])


def _row_mode_name(scene) -> str:
    """The row mode the reduced K5 and K7 take for ``scene``'s table."""
    from raytrace_tpu_torch.ops.row_reduce import STAGED, row_mode
    n_prims = scene.prims.kind.shape[0]
    mode = row_mode(n_prims, 15 if scene.prims.has_motion else 9)
    return f"{'staged' if mode == STAGED else 'global'} mode, {n_prims} rows"


def _bwd_bound(n_lanes: int, n_in: int, n_out: int, tables, n_row: int):
    """``_bound_ms`` of a reduced backward kernel: ``n_in`` lane columns
    read and ``n_out`` written, the table, the prims' material and texture
    rows read and the reduced tables written once; ~1000 float operations
    a lane (lane_math's replay and its reverse sweep)."""
    t = tables
    n_bytes = 4 * (n_lanes * (n_in + n_out) + t.cols.numel() + 2 * t.n_prims
                   + t.n_prims * n_row + t.n_mats + 6 * t.n_tex)
    return _bound_ms(n_bytes, n_lanes * 1000)


def _in_turns(label: str, run, iters: int, smi: str) -> dict:
    """The fwd+bwd ``run`` (``iters`` iterations) with the backward before
    the reduction moved into K5 and K7 (``testing.per_lane_backward``:
    their per-lane modes with torch's gather and ``index_add_`` around
    them) and with the reduced kernels, in turns: per lane, reduced,
    reduced, per lane.  Each turn prints the wall and peak memory of an
    unprofiled run, and the device time per iteration and the index ops
    run inside the backward steps from a profiled one.  Raises if the
    reduced backward runs an index op, or the per-lane one none."""
    import torch
    from raytrace_tpu_torch.testing import per_lane_backward
    out = {"per_lane": [], "reduced": []}
    for mode in ("per_lane", "reduced", "reduced", "per_lane"):
        with (per_lane_backward() if mode == "per_lane"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            prof = _profile_fwd_bwd(run, iters)
        out[mode].append(dict(wall_s=wall, peak_bytes=peak, **prof))
        print(f"[in turns] {label}, {'per-lane K5/K7 + torch gather and '
              'index_add_' if mode == 'per_lane' else 'reduced K5/K7'}: "
              f"wall {wall:.3f} s, peak {peak / 2**30:.3f} GiB, device "
              f"{prof['device_ms_per_iter']:.4f} ms an iteration, index ops "
              f"in the backward steps {prof['backward_index_ops']} [{smi}]",
              flush=True)
    if any(t["backward_index_ops"] for t in out["reduced"]) \
            or not all(t["backward_index_ops"] for t in out["per_lane"]):
        raise AssertionError(f"{label}: index ops in the reduced backward, "
                             "or none found in the per-lane one")
    return out


def _marble_sass_count() -> str:
    """K12's SASS (``cuobjdump -sass`` of the build's object, also written
    to chiprun_out/sass_texture_kernel.txt): the kernel's instructions,
    those of its fast path (:func:`fast_path_count`: without
    sqrt's slow call and the trigonometric functions' Payne-Hanek
    reduction, which the gradient's angle in [0, 2 pi) never takes; a
    thread's two octaves are unrolled), and the fast path's instructions
    that a marble lane's threads issue."""
    from raytrace_tpu_torch.ops._build import CSRC
    fns = sass_functions("texture_kernel")
    if not fns:
        return "no object or no cuobjdump"
    with open(os.path.join(OUT_DIR, "sass_texture_kernel.txt"), "w") as f:
        f.write(sass_text("texture_kernel"))
    ins = next(v for k, v in fns.items() if "marble_kernel" in k)
    src = (CSRC / "texture_kernel.cu").read_text()
    width = 1
    for name in ("kSplit", "kOct"):
        width *= int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
    fast = fast_path_count(ins, ins[0][0], ins[-1][0])
    return (f"{len(ins)} instructions, {fast} on the fast path; a marble "
            f"lane's {width} threads issue {width * fast} (MARBLE_OPS "
            f"{MARBLE_OPS}: one thread a lane)")


def _bound_ms(n_bytes: float, n_ops: float):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and operations over the float32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _walk_touch(tb, rays, kw):
    """``(visits, touched_bytes)`` of K9 over ``rays``: the box and row
    tests of each ray, and the bytes of the distinct nodes and leaf rows
    the walk reads (each node and row once), which its bound counts."""
    import torch
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    bvh = tb.bvh
    seen = torch.zeros(bvh.n_nodes + bvh.rows.shape[0], dtype=torch.uint8,
                       device=bvh.nodes.device)
    out, visits = allpairs_nearest_record(tb.ptbl, bvh, *rays,
                                          count_visits=True, seen=seen, **kw)
    nodes = int(seen[:bvh.n_nodes].sum())
    rows = int(seen[bvh.n_nodes:].sum())
    return out, visits, 4 * (nodes * bvh.nodes.shape[1]
                             + rows * bvh.rows.shape[1]), (nodes, rows)


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device (there is no CPU "
                           "fallback)")
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, bounce_plain,
    )
    from raytrace_tpu_torch.ops.iter_kernel import (
        Rotation, iter_megakernel, iter_plain,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.integrator import (
        bounce_tables, rotation_stride,
    )
    from raytrace_tpu_torch.render.render import (
        render_accumulate, rotate_k_for,
    )
    from raytrace_tpu_torch.testing import (
        ALL_MATERIAL_TARGETS, BOUNCE_INT_ROWS, BWD_RTOL, FRAC_LANES, FWD_BWD,
        ITER_INT_ROWS,
        MEAN_RTOL, MESH_FWD_BWD, all_materials_scene, bounce_inputs,
        box_motion_scene, bunny_standin_scene, bwd_inputs, checked_launches,
        compare_bounce, compare_bwd, compare_iter, cornell_scene_and_settings,
        fresh_carry, fwd_bwd_pixels, max_errs, next_bounce_inputs,
        per_lane_backward, plain_backward, primary_bounce_inputs,
        reduced_args, stationary_lanes,
    )
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.materials.materials import MAT_LIGHT
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
        bounce_bwd_regen_pre_reduced_plain,
    )
    from raytrace_tpu_torch.ops.row_reduce import row_tables

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase_done(name):
        torch.cuda.synchronize()
        print(f"[elapsed] {name}: {time.perf_counter() - t_start:.1f} s",
              flush=True)

    # 1. device
    smi = _smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    log = (_build.BUILD_DIR / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "bytes stack" in ln] \
        if log.exists() else ["(library was already built)"]
    print(f"[build] {build_s:.1f} s; ptxas: {' | '.join(ptxas)}", flush=True)

    phase_done("build")

    # 3. kernel A vs plain: the tables prepared as the drivers launch them
    # (the planar instantiation for Cornell's 18 parallelograms, the
    # general one for the all-materials scene), and Cornell's table once
    # through the general instantiation (unprepared)
    cornell, s_c = cornell_scene_and_settings(600, 200, 50, device=dev)
    n_pix, lanes, lane_pix = stationary_lanes(s_c)
    tb_c = bounce_tables(cornell, s_c)
    inst = lambda tb: "planar" if tb.launch.planar else "general"
    a_args = primary_bounce_inputs(cornell, s_c, 1)
    errs, out = compare_bounce(tb_c, a_args)
    err_a = _check(f"kernel A vs plain ({inst(tb_c)}): cornell 600x600 "
                   "primary rays", errs, lanes)
    errs, _ = compare_bounce(tb_c, next_bounce_inputs(a_args, out, 1, 1))
    err_a = max(err_a, _check(f"kernel A vs plain ({inst(tb_c)}): cornell "
                              "600x600 second bounce", errs, lanes))
    err_a = max(err_a, _check(
        "kernel A vs plain (general, unprepared): cornell 600x600 primary "
        "rays", max_errs(bounce_plain(tb_c.ptbl, tb_c.mtbl, tb_c.ttbl,
                                      *a_args, **tb_c.kw),
                         bounce_megakernel(tb_c.ptbl, tb_c.mtbl, tb_c.ttbl,
                                           *a_args, **tb_c.kw),
                         BOUNCE_INT_ROWS), lanes))
    if not tb_c.launch.planar:
        raise AssertionError("Cornell's table did not take the planar scan")
    allm = all_materials_scene(device=dev)
    s_a = rt.CameraSettings(background=rt.const_background([0.5, 0.6, 0.7]))
    s_at = s_a.with_redirect_targets(ALL_MATERIAL_TARGETS)
    n = 1 << 16
    for name, sc, s, box, seed in (
            ("cornell", cornell, s_c, (0.0, 555.0), 11),
            ("all-materials", allm, s_a, (-8.0, 8.0), 12),
            ("all-materials+targets", allm, s_at, (-8.0, 8.0), 13)):
        tb = bounce_tables(sc, s)
        errs, _ = compare_bounce(tb, bounce_inputs(sc, n, seed, box))
        err_a = max(err_a, _check(f"kernel A vs plain ({inst(tb)}): {name} "
                                  "random rays", errs, n))

    phase_done("kernel A vs plain")

    # 4. kernel B vs plain at the main path's shapes, prepared as the
    # drivers launch it: the planar instantiation on Cornell, the general
    # one on the all-materials (with and without targets) and moving-box
    # scenes, every lane of a 600-pixel-wide image
    err_b = 0.0
    box, s_box = box_motion_scene(device=dev)
    s_box = s_box.replace(image_width=600)
    s_a6 = s_a.replace(image_width=600)
    for name, sc, s, box_o, seed in (
            ("cornell 600x600 exact", cornell, s_c, (0.0, 555.0), 21),
            ("cornell 600x600 rr2", cornell, s_c.replace(rr_depth=2),
             (0.0, 555.0), 22),
            ("all-materials 600 wide exact", allm, s_a6, (-8.0, 8.0), 23),
            ("all-materials+targets 600 wide rr2", allm,
             s_a6.with_redirect_targets(ALL_MATERIAL_TARGETS).replace(
                 rr_depth=2), (-8.0, 8.0), 24),
            ("box/motion 600 wide exact", box, s_box, (-8.0, 8.0), 25),
            ("box/motion 600 wide rr2", box, s_box.replace(rr_depth=2),
             (-8.0, 8.0), 26)):
        n_b = stationary_lanes(s)[1]
        p0 = iter_megakernel.planar_launches
        one, frac, mean_rel, err30 = compare_iter(sc, s, n_b, seed,
                                                  box=box_o)
        b_inst = ("planar" if iter_megakernel.planar_launches > p0
                  else "general")
        if (b_inst == "planar") != (sc is cornell):
            raise AssertionError(f"kernel B took the {b_inst} instantiation "
                                 f"on {name}")
        err_b = max(err_b, _check(f"kernel B vs plain ({b_inst}): {name}, "
                                  "one iteration", one, n_b))
        err_b = max(err_b, err30)
        print(f"[kernel B vs plain] ({b_inst}) {name}, 30 iterations: "
              f"{frac:.5f} of lanes differ by > 1e-5 (bound {FRAC_LANES}), "
              f"mean rel diff {mean_rel:.2e} (bound {MEAN_RTOL}), max |err| "
              f"{err30:.3g} of the summed radiance, {n_b} lanes", flush=True)
        if frac >= FRAC_LANES or mean_rel > MEAN_RTOL:
            raise AssertionError("kernel B disagrees with iter_plain over "
                                 "30 iterations")

    phase_done("kernel B vs plain")

    # 5./6. the main path
    bounce_megakernel.launches = 0
    iter_megakernel.launches = 0
    iter_megakernel.planar_launches = 0
    runs = {}
    for name, s, spp in (("exact", s_c, FWD_SPP),
                         ("rr2", s_c.replace(rr_depth=2), FWD_SPP),
                         ("spp1", s_c, 1)):
        a0, b0 = bounce_megakernel.launches, iter_megakernel.launches
        bp0 = iter_megakernel.planar_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, total = render_accumulate(cornell, s, seed=1, spp=spp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        img = acc / total
        la = bounce_megakernel.launches - a0
        lb = iter_megakernel.launches - b0
        lbp = iter_megakernel.planar_launches - bp0
        finite = bool(torch.isfinite(img).all())
        mean = float(img.mean())
        runs[name] = dict(seconds=dt, rays_per_s=n_pix * spp / dt,
                          kernel_a=la, kernel_b=lb, mean=mean)
        iters = la + lb
        print(f"[main path] cornell 600x600 {spp} spp depth 50 {name}: "
              f"{dt:.3f} s, {n_pix * spp / dt / 1e6:.3f} M primary rays/s, "
              f"{iters} iterations ({1e3 * dt / max(iters, 1):.3f} ms/iter), "
              f"launches A={la} B={lb} (planar {lbp}), mean {mean:.6f}, "
              f"finite {finite} "
              f"[{smi}]", flush=True)
        if not finite or img.shape != (n_pix, 3):
            raise AssertionError(f"main path {name}: bad image")
        if la != 0 or lb == 0 or lbp != lb:
            raise AssertionError(f"main path {name}: kernel B did not run "
                                 "alone, or not through its planar "
                                 "instantiation")
        if name == "exact":
            write_image(os.path.join(OUT_DIR, "cornell600.png"),
                        img.reshape(600, 600, 3))
    main_a, main_b = bounce_megakernel.launches, iter_megakernel.launches
    rel = abs(runs["rr2"]["mean"] / runs["exact"]["mean"] - 1.0)
    print(f"[main path] mean exact vs rr2: rel diff {rel:.4f} (bound 0.03)",
          flush=True)
    if rel > 0.03:
        raise AssertionError("Russian roulette changed the image mean")
    if main_b == 0:
        raise AssertionError("kernel B never launched on the main path")

    phase_done("forward main path")

    # the main path again, every launch held against its plain version:
    # 16 spp rotates as the main path's 64 do (k_rot 8, spp_k 2: the
    # chunk a real division, eight planes), 2 spp at k_rot 2 with spp_k 1
    s_rr = s_c.replace(rr_depth=2)
    for name, s, spp in (("exact", s_c, CHECKED_ROT_SPP),
                         ("rr2", s_rr, CHECKED_ROT_SPP),
                         ("exact", s_c, 2), ("rr2", s_rr, 2),
                         ("exact", s_c, 1), ("rr2", s_rr, 1)):
        with checked_launches() as stats:
            acc, total = render_accumulate(cornell, s, seed=1, spp=spp)
        kernel = "iter_megakernel"
        st = stats[kernel]
        if st["launches"] == 0 or not bool(torch.isfinite(acc).all()):
            raise AssertionError(f"checked main path {spp} spp {name}: "
                                 f"{kernel} did not run or the image is "
                                 "not finite")
        err = _check(f"main path checked: cornell 600x600 {spp} spp {name}, "
                     f"{st['launches']} launches of {kernel}",
                     (st["n_int"], st["err"], st["excess"]), lanes)
        err_b = max(err_b, err)

    phase_done("checked forward renders")

    # 7. kernel times at the main path's 360,064 lanes: device time per
    # launch, and the wrapper's call back to back (its host cost)
    a_call = lambda: bounce_megakernel(tb_c.ptbl, tb_c.mtbl, tb_c.ttbl,
                                       *a_args, **tb_c.kw,
                                       prepared=tb_c.launch)
    ms_a = _device_ms(a_call, "bounce_kernel", 50)
    host_a = _time_ms(a_call, 50)
    plain_a = _time_ms(lambda: bounce_plain(tb_c.ptbl, tb_c.mtbl, tb_c.ttbl,
                                            *a_args, **tb_c.kw), 5, 1)
    print(f"[time] kernel A ({inst(tb_c)}) {ms_a:.4f} ms on the device "
          f"({host_a:.4f} ms a call back to back) vs bounce_plain "
          f"{plain_a:.3f} ms at {lanes} lanes (primary rays) [{smi}]",
          flush=True)
    # the scan's share: the same wrapper with no rows (the shade and the
    # lane I/O alone), and the general instantiation over Cornell's rows
    ms_a0 = _device_ms(lambda: bounce_megakernel(
        tb_c.ptbl, tb_c.mtbl, tb_c.ttbl, *a_args,
        **dict(tb_c.kw, n_prims=0)), "bounce_kernel", 50)
    ms_ag = _device_ms(lambda: bounce_megakernel(
        tb_c.ptbl, tb_c.mtbl, tb_c.ttbl, *a_args, **tb_c.kw),
        "bounce_kernel", 50)
    print(f"[split] kernel A at {lanes} lanes: {ms_a:.4f} ms with Cornell's "
          f"{tb_c.n_prims} rows (planar), {ms_ag:.4f} ms (general), "
          f"{ms_a0:.4f} ms with n_prims=0 (the shade and the lane I/O); "
          f"ptxas: {' | '.join(ptxas_report(('bounce_kernel',)))} [{smi}]",
          flush=True)
    b_tables, b_kw = iter_kernel_args(cornell, s_c, rng.base_key(1, dev), 199)
    b_lane = ((torch.from_numpy(lane_pix).to(dev, torch.int32),)
              + fresh_carry(lanes, dev))
    b_gen = dict(b_kw, prepared=None)     # unprepared: the general one
    if not b_kw["prepared"].planar:
        raise AssertionError("Cornell's table did not take kernel B's "
                             "planar scan")
    b_ref = iter_plain(*b_tables, b_lane, **b_kw)
    for b_inst, kw_x in (("planar", b_kw), ("general, unprepared", b_gen)):
        err_b = max(err_b, _check(
            f"kernel B vs plain ({b_inst}): cornell 600x600 every lane "
            "regenerating", max_errs(b_ref, iter_megakernel(
                *b_tables, b_lane, **kw_x), ITER_INT_ROWS), lanes))
    b_call = lambda: iter_megakernel(*b_tables, b_lane, **b_kw)
    ms_b = _device_ms(b_call, "iter_kernel", 50)
    b_gen_call = lambda: iter_megakernel(*b_tables, b_lane, **b_gen)
    # the host's clock varies between calls: 5 turns of 50 calls each,
    # prepared and unprepared, the least of each kept
    turns_b = [(_time_ms(b_call, 50), _time_ms(b_gen_call, 50))
               for _ in range(5)]
    host_b, host_bu = (min(t[k] for t in turns_b) for k in (0, 1))
    plain_b = _time_ms(lambda: iter_plain(*b_tables, b_lane, **b_kw), 5, 1)
    print(f"[time] kernel B (planar) {ms_b:.4f} ms on the device "
          f"({host_b:.4f} ms a call back to back, prepared; {host_bu:.4f} "
          f"unprepared; the least of 5 turns: "
          f"{', '.join(f'{a:.4f}/{b:.4f}' for a, b in turns_b)}) vs "
          f"iter_plain {plain_b:.3f} ms at {lanes} lanes (regenerating "
          f"every lane) [{smi}]", flush=True)
    # the scan's share: the same wrapper with no rows (regeneration, shade,
    # background, RR and the lane I/O alone), and the general
    # instantiation over Cornell's rows
    ms_bg = _device_ms(b_gen_call, "iter_kernel", 50)
    ms_b0 = _device_ms(lambda: iter_megakernel(
        *b_tables, b_lane, **dict(b_gen, n_prims=0)), "iter_kernel", 50)
    print(f"[split] kernel B at {lanes} lanes: {ms_b:.4f} ms with Cornell's "
          f"{b_kw['n_prims']} rows (planar), {ms_bg:.4f} ms (general), "
          f"{ms_b0:.4f} ms with n_prims=0; ptxas: "
          f"{' | '.join(ptxas_report(('iter_kernel',)))} [{smi}]",
          flush=True)
    for line in sass_loops("iter_kernel"):
        print(f"[sass] {line}", flush=True)
    # kernel B's rotated mode as the main path launches it (FWD_SPP: k_rot
    # 8, spp_k 8) on the same lanes, lane l's sample in chunk l mod k_rot
    # so that every warp adds into all the planes: checked against its
    # plain version (lanes and planes), then timed and bounded
    k_m = rotate_k_for(FWD_SPP)
    spp_m = FWD_SPP // k_m
    rot_b = Rotation(k_m, spp_m, rotation_stride(lanes, k_m), 0, 0, n_pix,
                     torch.zeros((k_m, 3, lanes), device=dev))
    chunk = torch.arange(lanes, device=dev, dtype=torch.int32) % k_m
    b_lane_r = (b_lane[0], chunk * spp_m - 1) + b_lane[2:]
    rot_ref = dataclasses.replace(rot_b, planes=rot_b.planes.clone())
    ref_r = iter_plain(*b_tables, b_lane_r, **b_kw, rotation=rot_ref)
    out_r = iter_megakernel(*b_tables, b_lane_r, **b_kw, rotation=rot_b)
    n_died_r = int((out_r[16] > 0.5).sum())
    err_b = max(err_b, _check(
        f"kernel B rotated vs plain (planar): cornell 600x600 k_rot {k_m} "
        f"spp_k {spp_m}, lanes in every chunk, {n_died_r} dying",
        max_errs(ref_r + (rot_ref.planes,), out_r + (rot_b.planes,),
                 ITER_INT_ROWS), lanes))
    if n_died_r == 0 or not bool((rot_b.planes != 0).any(1).any(1).all()):
        raise AssertionError("kernel B rotated: no lane died, or a plane "
                             "took no add")
    br_call = lambda: iter_megakernel(*b_tables, b_lane_r, **b_kw,
                                      rotation=rot_b)
    ms_br = _device_ms(br_call, "iter_kernel", 50)
    host_br = min(_time_ms(br_call, 50) for _ in range(5))
    print(f"[time] kernel B rotated (planar, k_rot {k_m}, spp_k {spp_m}) "
          f"{ms_br:.4f} ms on the device ({host_br:.4f} ms a call back to "
          f"back, the least of 5 turns) against {ms_b:.4f} ({host_b:.4f}) "
          f"unrotated at {lanes} lanes, {n_died_r} dying [{smi}]",
          flush=True)

    # bounds: each input column read once and each output written once;
    # operations estimated per lane from the sources (a row of the scan
    # ~45, the shade ~300, the hash, camera and RR ~150; K5's replay and
    # its reverse sweep ~1000), all at the float32 rate
    bound_a = _bound_ms(4 * lanes * (11 + 8 + 15),
                        lanes * (45 * tb_c.n_prims + 300))
    bound_b = _bound_ms(4 * lanes * (17 + 19),
                        lanes * (45 * tb_c.n_prims + 450))
    # the rotated mode computes the pixel instead of reading it, and a
    # dying lane reads and writes its 3 floats of a plane; the chunk and
    # slot ~10 operations more a lane
    bound_br = _bound_ms(4 * lanes * (16 + 19) + 2 * 12 * n_died_r,
                         lanes * (45 * tb_c.n_prims + 460))
    print(f"[bound] kernel A {bound_a[0]:.4f} ms ({bound_a[1]}), kernel B "
          f"{bound_b[0]:.4f} ms ({bound_b[1]}), kernel B rotated "
          f"{bound_br[0]:.4f} ms ({bound_br[1]}) at {lanes} lanes",
          flush=True)

    phase_done("kernel times")

    # 8. K5 vs plain on 2^18 lanes of real mid-render states
    n_bwd = FWD_BWD["lanes"]
    s_fb = s_c.replace(rr_depth=FWD_BWD["rr_depth"])
    err_k5 = 0.0
    k5_args = None
    standin, s_st = bunny_standin_scene(600, MESH_FWD_BWD["spp"], 10,
                                        device=dev)
    for name, sc, s, pixels, n in (
            ("cornell fwd+bwd", cornell, s_fb,
             fwd_bwd_pixels(n_pix, n_bwd), n_bwd),
            ("all-materials", allm, s_a6, None, n_bwd),
            ("all-materials 2 targets", allm,
             s_a6.with_redirect_targets(ALL_MATERIAL_TARGETS), None, n_bwd),
            ("box/motion", box, s_box, None, n_bwd),
            ("box/motion 2 targets", box,
             s_box.with_redirect_targets(ALL_MATERIAL_TARGETS), None, n_bwd),
            ("bunny stand-in mesh fwd+bwd", standin,
             s_st.replace(rr_depth=MESH_FWD_BWD["rr_depth"]), None,
             MESH_FWD_BWD["lanes"])):
        args, kw = bwd_inputs(sc, s, n, 31, n_iters=4,
                              spp=FWD_BWD["spp"], pixels=pixels)
        (err, excess), _ = compare_bwd(args, kw)
        torch.cuda.synchronize()
        print(f"[K5 vs plain] {name}: {n} lanes x {kw['n_row'] + 20} "
              f"outputs, {int((args[6] > 0.5).sum())} alive, max |err| "
              f"{err:.3g}, worst excess {excess:.3g} (rtol {BWD_RTOL} of "
              "|plain| + output max + lane max) at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        if not excess <= 0.0:
            raise AssertionError(f"K5 vs plain: {name}: out of tolerance")
        tables = row_tables(sc, kw["n_row"])
        err_k5 = max(err_k5, err, _check_reduced(
            f"K5 reduced vs plain: {name}", args, kw, tables))
        if k5_args is None:
            k5_args, k5_kw, k5_tables = args, kw, tables

    phase_done("K5 vs plain")

    # 9. fwd+bwd with K5 against the same with its plain backward
    params, statics = partition(cornell)
    key = rng.base_key(0, dev)
    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=8, n_iters=40, remat=False)
    k0 = bounce_bwd_regen_pre_reduced.launches
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_fb, key, pix9, tgt9,
                                     **kw9)
    if bounce_bwd_regen_pre_reduced.launches - k0 != kw9["n_iters"]:
        raise AssertionError("fwd+bwd at 2^14 lanes: the reduced K5 did not "
                             "launch once per iteration")
    with plain_backward():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max(float(np.abs(g_k[k] - g_p[k]).max())
                / max(float(np.abs(g_p[k]).max()), 1e-30) for k in g_p)
    print(f"[fwd+bwd K5 vs plain] {n9} lanes, 8 spp, 40 iterations: loss "
          f"{float(l_k):.6f} vs {float(l_p):.6f}, samples {float(f_k):.4f}, "
          f"worst leaf max|diff|/max|plain| {worst:.3g} (bound {GRAD_RTOL})",
          flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst <= GRAD_RTOL:
        raise AssertionError("fwd+bwd: K5 and its plain version disagree")

    phase_done("fwd+bwd K5 vs plain")

    # 10. the fwd+bwd main path at bench size
    pix_fb = fwd_bwd_pixels(n_pix, n_bwd).to(dev)
    tgt_fb = torch.zeros((n_bwd, 3), device=dev)

    def fwd_bwd():
        return loss_and_grads(
            params, statics, s_fb, key, pix_fb, tgt_fb, spp=FWD_BWD["spp"],
            n_iters=FWD_BWD["n_iters"], remat=False,
            schedule=FWD_BWD["schedule"])

    fwd_bwd()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iter_megakernel.launches = 0
    iter_megakernel.planar_launches = 0
    bounce_bwd_regen_pre_reduced.launches = 0
    bounce_bwd_regen_pre_megakernel.launches = 0
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fb_b = iter_megakernel.launches
    fb_bp = iter_megakernel.planar_launches
    fb_k5 = bounce_bwd_regen_pre_reduced.launches
    fb_k5_lane = bounce_bwd_regen_pre_megakernel.launches
    peak = torch.cuda.max_memory_allocated()
    gnp = grads_to_numpy(grads)
    finite = all(bool(np.isfinite(v).all()) for v in gnp.values())
    fb = dict(seconds=wall, rays_per_s=n_bwd * FWD_BWD["spp"] / wall,
              loss=float(loss), samples_completed=float(frac),
              launches_iter=fb_b, launches_bwd=fb_k5, peak_bytes=peak)
    n_expect = FWD_BWD["n_iters"] + sum(i for i, _ in FWD_BWD["schedule"])
    print(f"[main path fwd+bwd] cornell 600x600 depth 50 rr2, {n_bwd} lanes "
          f"x {FWD_BWD['spp']} spp: {wall:.3f} s, "
          f"{fb['rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
          f"{fb['loss']:.6f}, samples_completed {fb['samples_completed']:.6f},"
          f" launches B={fb_b} (planar {fb_bp}) K5 reduced={fb_k5} "
          f"({_row_mode_name(cornell)}) "
          f"K5 per lane={fb_k5_lane}, "
          f"peak memory {peak / 2**30:.3f} GiB, gradients finite {finite} "
          f"[{smi}]", flush=True)
    if not finite or fb["samples_completed"] < 0.9999 \
            or fb_b != n_expect or fb_bp != fb_b or fb_k5 != n_expect \
            or fb_k5_lane:
        raise AssertionError("fwd+bwd main path: bad gradients, incomplete "
                             "samples or wrong launch counts")
    main_b += fb_b

    phase_done("fwd+bwd main path")

    # 11. finite differences on the card (exact estimator: the paths do
    # not depend on an emission or an albedo)
    s_fd = s_c.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=8, n_iters=80, remat=False)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex, mats = cornell.textures, cornell.materials
    light = int(mats.tex[(mats.kind == MAT_LIGHT).nonzero()[0, 0]])
    red = int(torch.argmax(tex.c0[:, 0] - tex.c0[:, 1]))
    for name, ti, eps in (("light emission", light, 0.5),
                          ("red wall albedo", red, 1e-2)):
        def loss_at(x, ti=ti):
            c0 = tex.c0.clone()
            c0[ti, 0] = x[0]
            sc = dataclasses.replace(
                cornell, textures=dataclasses.replace(tex, c0=c0))
            with torch.no_grad():
                return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                             tgt_fd, **kw_fd)[0]
        fd = float(finite_difference(loss_at, tex.c0[ti, 0:1].clone(),
                                     eps)[0])
        gv = float(g_fd.textures.c0[ti, 0])
        print(f"[finite difference] {name} (texture {ti}, red channel): "
              f"gradient {gv:.6g}, central difference {fd:.6g} (eps {eps}),"
              f" rel diff {abs(gv - fd) / abs(fd):.3g} (bound {FD_RTOL})",
              flush=True)
        if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
            raise AssertionError(f"finite difference: {name}")

    phase_done("finite differences")

    # 12. K5's time at 2^18 lanes (the Cornell fwd+bwd state of phase 8):
    # the reduced mode's device time (its kernel and the two finishing
    # launches) and its wrapper's call back to back; the per-lane mode's
    # device time, and that of the torch gather and index_add_ around it
    # that the reduced mode took in
    k5_red = lambda: bounce_bwd_regen_pre_reduced(
        *reduced_args(k5_args, k5_tables), **k5_kw)
    ms_k5 = _device_ms(k5_red, ("bounce_bwd_kernel", "row_sum_kernel",
                                "row_map_kernel"), 50)
    ms_k5_main = _device_ms(k5_red, "bounce_bwd_kernel", 50)
    host_k5 = _time_ms(k5_red, 50)
    k5_lane = lambda: bounce_bwd_regen_pre_megakernel(*k5_args, **k5_kw)
    ms_k5_lane = _device_ms(k5_lane, "bounce_bwd_kernel", 50)
    host_k5_lane = _time_ms(k5_lane, 50)
    with per_lane_backward():
        from raytrace_tpu_torch.diff import fused_iter
        old_k5 = fused_iter.bounce_bwd_regen_pre_reduced
        old_call = lambda: old_k5(*reduced_args(k5_args, k5_tables),
                                  **k5_kw)
        total_old = _device_total_ms(old_call, 10)
        host_old = _time_ms(old_call, 10)
    plain_k5 = _time_ms(lambda: bounce_bwd_regen_pre_reduced_plain(
        *reduced_args(k5_args, k5_tables), **k5_kw), 3, 1)
    bound_k5 = _bwd_bound(n_bwd, 29, 13, k5_tables, k5_kw["n_row"])
    print(f"[time] K5 reduced {ms_k5:.4f} ms on the device ({ms_k5_main:.4f}"
          f" ms the kernel, the rest the finishing launches; {host_k5:.4f} ms"
          f" a call back to back) vs "
          f"its plain version {plain_k5:.3f} ms at {n_bwd} lanes, "
          f"bound {bound_k5[0]:.4f} ms ({bound_k5[1]}: 29 columns in, 13 "
          f"out, the table and the reduced tables); before: the per-lane "
          f"mode {ms_k5_lane:.4f} ms on the device ({host_k5_lane:.4f} ms a "
          f"call), with the torch gather and index_add_ around it "
          f"{total_old:.4f} ms of device time a call ({host_old:.4f} ms a "
          f"call back to back) [{smi}]", flush=True)

    phase_done("K5 time")

    # the fwd+bwd main path with the backward before the reduction moved
    # into K5 and with the reduced K5, in turns
    turns = {"fwd_bwd": _in_turns("cornell fwd+bwd", fwd_bwd, n_expect, smi)}

    phase_done("fwd+bwd in turns")

    mesh = _mesh_phases(smi, phase_done)
    rich = _rich_phases(smi, phase_done, dev)
    media = _media_phases(smi, phase_done, dev)
    unfused = _unfused_phases(smi, phase_done, dev)
    generic = _generic_phases(smi, phase_done, dev)
    m11 = _m11_phases(smi, phase_done, dev)
    big = _bigmesh_phases(smi, phase_done, dev)
    scenes = _scene_phases(smi, phase_done, dev)
    par = _parallel_phases(smi, phase_done, dev)
    stats = _stats_phases(smi, phase_done, dev)
    sorted_turn = _sorted_turn_phases(smi, phase_done, dev)
    turns["route8"] = unfused.pop("turns")
    main_a += unfused["a_launches"] + scenes["a_launches"] \
        + par["a_launches"] + stats["launches"]["A"]
    main_b += (rich["iter_launches"] + par["b_launches"]
               + stats["launches"]["B"])
    mesh["kernels"][0]["launches"] += (media["k9_launches"]
                                       + generic["k9_launches"]
                                       + m11["k9_launches"]
                                       + big["k9_launches"]
                                       + stats["launches"]["K9"])
    # K9 at bigmesh-512's 523,328 rows beside the stand-in's numbers
    k9 = mesh["kernels"][0]
    k9["max_abs_err"] = max(k9["max_abs_err"], big["err_k9"])
    k9.update({f"bigmesh_{name}": val for name, val in big["k9"].items()})
    mesh["kernels"][1]["launches"] += (rich["shade_launches"]
                                       + media["shade_launches"]
                                       + unfused["shade_launches"]
                                       + m11["k10_launches"]
                                       + big["k10_launches"]
                                       + scenes["k10_launches"]
                                       + stats["launches"]["K10"])
    mesh["kernels"][2]["launches"] += rich["mesh_iter_launches"]
    rich["kernels"][0]["launches"] += (media["k8_launches"]
                                       + unfused["k8_launches"]
                                       + generic["k8_launches"]
                                       + m11["k8_launches"]
                                       + scenes["k8_launches"])
    rich["kernels"][1]["launches"] += (generic["k12_launches"]
                                       + m11["k12_launches"])
    rich["kernels"][2]["launches"] += m11["k13_launches"]
    media["kernels"][0]["launches"] += (unfused["k11_launches"]
                                        + generic["k11_launches"]
                                        + m11["k11_launches"])
    media["kernels"][1]["launches"] += (unfused["k11b_launches"]
                                        + generic["k11b_launches"]
                                        + stats["launches"]["K11b"])
    media["kernels"][0].update(generic["keyed"]["K11"])
    media["kernels"][1].update(generic["keyed"]["K11b"])
    print(json.dumps({"main_path": runs, "fwd_bwd": fb,
                      "mesh": mesh["summary"], "rich": rich["summary"],
                      "media": media["summary"],
                      "unfused": unfused["summary"],
                      "generic": generic["summary"],
                      "m11": m11["summary"], "bigmesh": big["summary"],
                      "scenes": scenes["summary"],
                      "parallel": par["summary"],
                      "driver_stats": stats["summary"],
                      "sorted_turn": sorted_turn["summary"],
                      "in_turns": turns,
                      "build_seconds": build_s}), flush=True)
    no_lib = None   # no single PyTorch call computes a bounce
    print(json.dumps({"kernels": [
        {"name": "bounce_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/bounce_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/bounce_kernel.py:523",
         "launches": main_a, "max_abs_err": err_a, "ms": ms_a,
         "host_ms": host_a, "plain_ms": plain_a, "bound_ms": bound_a[0],
         "bound_by": bound_a[1], "library_ms": no_lib,
         "general_ms": ms_ag, "no_rows_ms": ms_a0},
        {"name": "iter_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/iter_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/iter_kernel.py:328",
         "launches": main_b, "max_abs_err": err_b, "ms": ms_b,
         "host_ms": host_b, "plain_ms": plain_b, "bound_ms": bound_b[0],
         "bound_by": bound_b[1], "library_ms": no_lib,
         "general_ms": ms_bg, "no_rows_ms": ms_b0,
         "unprepared_host_ms": host_bu, "rotated_ms": ms_br,
         "rotated_host_ms": host_br, "rotated_bound_ms": bound_br[0],
         "rotated_bound_by": bound_br[1]},
        {"name": "bounce_bwd_regen_pre_reduced", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/bounce_bwd_kernel.cu",
         "replaces":
             "raytrace_tpu/ops/pallas/bounce_bwd_gather_kernel.py:497",
         "launches": fb_k5 + mesh["k5_launches"] + rich["k5_launches"]
         + par["k5_launches"],
         "max_abs_err": err_k5, "ms": ms_k5, "host_ms": host_k5,
         "plain_ms": plain_k5, "bound_ms": bound_k5[0],
         "bound_by": bound_k5[1], "library_ms": no_lib,
         "kernel_ms": ms_k5_main, "per_lane_ms": ms_k5_lane,
         "per_lane_host_ms": host_k5_lane,
         "per_lane_with_torch_reduction_ms": total_old,
         "per_lane_with_torch_reduction_host_ms": host_old},
    ] + mesh["kernels"] + rich["kernels"] + media["kernels"]
        + [unfused["kernel"], m11["kernel"]]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _mesh_phases(smi, phase_done) -> dict:
    """Phases 13-18 (the mesh scale).  Returns the summary for the JSON
    line, the K5 launches of route 2 and the ``kernels`` entries of the
    three mesh kernels."""
    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.fused_iter import iter_kernel_args
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.allpairs_kernel import (
        LEAF_SIZE, allpairs_nearest_plain, allpairs_nearest_record,
        bvh_boxes, pack_bvh,
    )
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel, shade_plain,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pack_prims
    from raytrace_tpu_torch.ops.iter_kernel import (
        iter_mega_ap, iter_megakernel, iter_plain,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.integrator import split_tables
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.scene.bvh import build_bvh
    from raytrace_tpu_torch.testing import (
        FRAC_LANES, MEAN_RTOL, MESH_FWD_BWD, bunny_standin_scene,
        camera_rays, checked_launches, compare_iter, compare_nearest,
        compare_shade, fresh_carry, mesh_all_kinds_scene, next_split_rays,
        plain_kernels, synthetic_medium, uv_sphere,
    )
    dev = torch.device("cuda", 0)
    standin, s_m = bunny_standin_scene(600, MESH_SPP, 10, device=dev)
    n_pix = s_m.image_width * s_m.image_height
    lanes = -(-n_pix // 128) * 128
    t0 = time.perf_counter()
    tb_m = split_tables(standin, s_m)
    print(f"[mesh] bunny stand-in: {standin.prims.n} triangles in "
          f"{standin.prims.kind.shape[0]} rows, kind segments "
          f"{standin.prims.kind_segments}; split tables + BVH "
          f"{time.perf_counter() - t0:.3f} s (BVH build "
          f"{tb_m.bvh.build_s:.3f} s, {tb_m.bvh.n_nodes} nodes)", flush=True)

    # 13./14. nearest and shade kernels vs plain
    err_n = err_s = 0.0
    n_k = 1 << 17
    v, f = uv_sphere(126, 200)
    big = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture([0.6, 0.6, 0.6])),
        rt.triangle_mesh(rt.Mesh(1.5 * v, np.zeros((0, 2)), f,
                                 np.full_like(f, -1)))), device=dev)
    s_big = rt.CameraSettings(center=[0.0, 1.0, 4.0], look_at=[0.0, 0.0, 0.0],
                              image_width=128, background=rt.gray_fade)
    cases = [("stand-in", standin, s_m, n_k)]
    for moving in (False, True):
        sc, s_k = mesh_all_kinds_scene(18, moving, 600, device=dev)
        cases.append((f"mesh all kinds{' moving' if moving else ''}", sc, s_k,
                      n_k))
    cases.append((f"{f.shape[0]}-triangle sphere", big, s_big, 1 << 14))
    # the device BVH's build (binned SAH, level by level) against the
    # median split that orders compile_scene's rows, over the same boxes,
    # best of 3 each
    for sc in (standin, big):
        n_r = sc.prims.kind.shape[0]
        tbl = pack_prims(sc.prims).contiguous()
        _, lo, hi = bvh_boxes(sc.prims, n_r)
        t_sah = min(pack_bvh(sc.prims, tbl, n_r).build_s for _ in range(3))
        t_med = []
        for _ in range(3):
            t0 = time.perf_counter()
            build_bvh(lo, hi, leaf_size=LEAF_SIZE)
            t_med.append(time.perf_counter() - t0)
        b = pack_bvh(sc.prims, tbl, n_r)
        print(f"[bvh build] {n_r} rows: pack_bvh {t_sah:.4f} s ({b.n_nodes} "
              f"two-box nodes, depth {b.depth}, triangle-only "
              f"{b.tri_only}) vs build_bvh {min(t_med):.4f} s over the same "
              f"boxes: ratio {t_sah / min(t_med):.3f}", flush=True)
    for name, sc, s_k, n in cases:
        tb = tb_m if sc is standin else split_tables(sc, s_k)
        comps, uni = camera_rays(sc, s_k, n, 41)
        thr = torch.ones((3, n), device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        for depth in (0, 1):
            errs, _ = compare_nearest(tb, comps)
            err_n = max(err_n, _check(
                f"nearest vs plain: {name} ({sc.prims.kind.shape[0]} rows, "
                f"BVH build {tb.bvh.build_s:.3f} s), bounce {depth + 1}",
                errs, n))
            errs, out, hit = compare_shade(tb, comps, uni, thr, alive)
            err_s = max(err_s, _check(f"shade vs plain: {name}, bounce "
                                      f"{depth + 1}", errs, n))
            med = synthetic_medium(hit[0], tb.n_mats, 43 + depth)
            errs, _, _ = compare_shade(tb, comps, uni, thr, alive,
                                       medium=med, hit=hit)
            err_s = max(err_s, _check(f"shade vs plain: {name}, bounce "
                                      f"{depth + 1}, synthetic medium",
                                      errs, n))
            if err_n or err_s:
                raise AssertionError("a mesh kernel is not exact")
            comps, uni, thr, alive = next_split_rays(comps, out, 41,
                                                     depth + 1)
    phase_done("nearest and shade kernels vs plain")

    # 15. kernel B's mesh variant vs plain
    err_m = 0.0
    for name, s_k, seed in (("exact", s_m, 51),
                            ("rr2", s_m.replace(rr_depth=2), 52)):
        one, frac, mean_rel, _ = compare_iter(standin, s_k, n_k, seed,
                                              n_iters=10, box=(-1.0, 1.0))
        err_m = max(err_m, _check(f"mesh iteration vs plain: stand-in "
                                  f"{name}, one iteration", one, n_k))
        print(f"[mesh iteration vs plain] stand-in {name}, 10 iterations: "
              f"{frac:.5f} of lanes differ by > 1e-5 (bound {FRAC_LANES}), "
              f"mean rel diff {mean_rel:.2e} (bound {MEAN_RTOL})",
              flush=True)
        if frac >= FRAC_LANES or mean_rel > MEAN_RTOL:
            raise AssertionError("the mesh iteration kernel disagrees with "
                                 "iter_plain over 10 iterations")
    phase_done("mesh iteration kernel vs plain")

    # 16. route 1: the split forward at full size
    counters = (bounce_megakernel, iter_megakernel, allpairs_nearest_record,
                shade_megakernel)
    for c in counters:
        c.launches = 0
    runs = {}
    for name, s_k in (("exact", s_m), ("rr2", s_m.replace(rr_depth=2))):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, total = render_accumulate(standin, s_k, seed=1, spp=MESH_SPP)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        la, lb, ln, ls = (c.launches - b for c, b in zip(counters, before))
        img = acc / total
        finite = bool(torch.isfinite(img).all())
        mean = float(img.mean())
        runs[name] = dict(seconds=dt, rays_per_s=n_pix * MESH_SPP / dt,
                          iterations=ln, nearest=ln, shade=ls, mean=mean)
        print(f"[route 1] stand-in 600x600 {MESH_SPP} spp depth 10 {name}: "
              f"{dt:.3f} s, {n_pix * MESH_SPP / dt / 1e6:.3f} M primary "
              f"rays/s, {ln} iterations ({1e3 * dt / max(ln, 1):.3f} "
              f"ms/iter), launches nearest={ln} shade={ls} A={la} B={lb}, "
              f"mean {mean:.6f}, finite {finite} [{smi}]", flush=True)
        if not finite or img.shape != (n_pix, 3) or ln == 0 or ls != ln \
                or la or lb:
            raise AssertionError(f"route 1 {name}: bad image or launches")
        if name == "exact":
            write_image(os.path.join(OUT_DIR, "mesh600.png"),
                        img.reshape(600, 600, 3))
    r1_nearest = allpairs_nearest_record.launches
    r1_shade = shade_megakernel.launches
    rel = abs(runs["rr2"]["mean"] / runs["exact"]["mean"] - 1.0)
    print(f"[route 1] mean exact vs rr2: rel diff {rel:.4f} (bound 0.03)",
          flush=True)
    if rel > 0.03:
        raise AssertionError("Russian roulette changed the mesh image mean")
    phase_done("route 1")
    for name, s_k in (("exact", s_m), ("rr2", s_m.replace(rr_depth=2))):
        with checked_launches() as stats:
            acc, _ = render_accumulate(standin, s_k, seed=1, spp=1)
        for kname in ("allpairs_nearest_record", "shade_megakernel"):
            st = stats[kname]
            if st["launches"] == 0 or not bool(torch.isfinite(acc).all()):
                raise AssertionError(f"checked route 1 {name}: {kname}")
            err = _check(f"route 1 checked: stand-in 600x600 1 spp {name}, "
                         f"{st['launches']} launches of {kname}",
                         (st["n_int"], st["err"], st["excess"]), lanes)
            if kname == "shade_megakernel":
                err_s = max(err_s, err)
            else:
                err_n = max(err_n, err)
    phase_done("checked route 1")

    # 17. route 2: the mesh fwd+bwd
    cfg = MESH_FWD_BWD
    params, statics = partition(standin)
    s_fb = s_m.replace(rr_depth=cfg["rr_depth"])
    key = rng.base_key(0, dev)
    pix_fb = (torch.arange(cfg["lanes"]) % n_pix).to(dev, torch.int32)
    tgt_fb = torch.zeros((cfg["lanes"], 3), device=dev)

    def fwd_bwd():
        return loss_and_grads(params, statics, s_fb, key, pix_fb, tgt_fb,
                              spp=cfg["spp"], n_iters=cfg["n_iters"],
                              remat=False, schedule=cfg["schedule"])

    fwd_bwd()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iter_mega_ap.launches = 0
    bounce_bwd_regen_pre_reduced.launches = 0
    bounce_bwd_regen_pre_megakernel.launches = 0
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r2_iter = iter_mega_ap.launches
    r2_k5 = bounce_bwd_regen_pre_reduced.launches
    r2_k5_lane = bounce_bwd_regen_pre_megakernel.launches
    peak = torch.cuda.max_memory_allocated()
    gnp = grads_to_numpy(grads)
    finite = all(bool(np.isfinite(x).all()) for x in gnp.values())
    n_expect = cfg["n_iters"] + sum(i for i, _ in cfg["schedule"])
    fb = dict(seconds=wall, rays_per_s=cfg["lanes"] * cfg["spp"] / wall,
              loss=float(loss), samples_completed=float(frac),
              launches_iter=r2_iter, launches_bwd=r2_k5, peak_bytes=peak)
    print(f"[route 2] stand-in fwd+bwd, {cfg['lanes']} lanes x {cfg['spp']} "
          f"spp, rr2, {cfg['n_iters']} iterations + {cfg['schedule']}: "
          f"{wall:.3f} s, {fb['rays_per_s'] / 1e6:.3f} M primary rays/s, "
          f"loss {fb['loss']:.6f}, samples_completed "
          f"{fb['samples_completed']:.6f}, launches mesh iteration={r2_iter} "
          f"K5 reduced={r2_k5} ({_row_mode_name(standin)}) K5 per lane="
          f"{r2_k5_lane}, peak memory "
          f"{peak / 2**30:.3f} GiB, gradients finite {finite} [{smi}]",
          flush=True)
    if not finite or r2_iter != n_expect or r2_k5 != n_expect or r2_k5_lane:
        raise AssertionError("route 2: bad gradients or launch counts")
    phase_done("route 2")

    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=4, n_iters=24, remat=False)
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_fb, key, pix9, tgt9,
                                     **kw9)
    with plain_kernels():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max(float(np.abs(g_k[k] - g_p[k]).max())
                / max(float(np.abs(g_p[k]).max()), 1e-30) for k in g_p)
    print(f"[route 2 kernels vs plain] {n9} lanes, 4 spp, 24 iterations: "
          f"loss {float(l_k):.6f} vs {float(l_p):.6f}, samples "
          f"{float(f_k):.4f} vs {float(f_p):.4f}, worst leaf "
          f"max|diff|/max|plain| {worst:.3g} (bound {GRAD_RTOL})",
          flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst <= GRAD_RTOL:
        raise AssertionError("route 2: the kernels and their plain versions "
                             "disagree")

    s_fd = s_m.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=4, n_iters=50, remat=False)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex = standin.textures

    def loss_at(x):
        c0 = tex.c0.clone()
        c0[0, 2] = x[0]
        sc = dataclasses.replace(standin,
                                 textures=dataclasses.replace(tex, c0=c0))
        with torch.no_grad():
            return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                         tgt_fd, **kw_fd)[0]
    fd = float(finite_difference(loss_at, tex.c0[0, 2:3].clone(), 1e-2)[0])
    gv = float(g_fd.textures.c0[0, 2])
    print(f"[finite difference] mesh albedo (blue channel): gradient "
          f"{gv:.6g}, central difference {fd:.6g} (eps 0.01), rel diff "
          f"{abs(gv - fd) / abs(fd):.3g} (bound {FD_RTOL})", flush=True)
    if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
        raise AssertionError("finite difference: mesh albedo")
    phase_done("route 2 checks")

    # 18. kernel times at the slice's shapes
    comps, uni = camera_rays(standin, s_m, lanes, 61)
    rays = tuple(comps.unbind(0))
    kw_n = dict(n_prims=tb_m.n_prims, t_min=tb_m.t_min,
                has_motion=tb_m.has_motion)
    hit_out, visits, touched_n, _ = _walk_touch(tb_m, rays, kw_n)
    n_call = lambda: allpairs_nearest_record(tb_m.ptbl, tb_m.bvh, *rays,
                                             **kw_n)
    ms_n = _device_ms(n_call, "nearest_kernel", 20)
    host_n = _time_ms(n_call, 20)
    plain_n = _time_ms(lambda: allpairs_nearest_plain(tb_m.ptbl, *rays,
                                                      **kw_n), 2, 1)
    nodes_v = float(visits[0].double().mean())
    rows_v = float(visits[1].double().mean())
    hit_v = hit_out[1] >= 0
    # the walk reads the nodes and the leaf-ordered rows, not the table:
    # K9's bound counts those it reads, the iteration's the whole tree
    tbl_bytes = 4 * (tb_m.bvh.nodes.numel() + tb_m.bvh.rows.numel())
    bound_n = _bound_ms(4 * lanes * (7 + 9) + touched_n,
                        lanes * (BOX_OPS * nodes_v + ROW_OPS * rows_v))
    print(f"[time] nearest kernel {ms_n:.4f} ms on the device ({host_n:.4f} "
          f"ms a call back to back) vs allpairs_nearest_plain "
          f"{plain_n:.3f} ms at {lanes} camera rays of the stand-in; a ray "
          f"makes {nodes_v:.2f} box tests and {rows_v:.2f} row tests on "
          f"average, a ray that hits ({float(hit_v.double().mean()):.4f} of "
          f"them) {float(visits[0][hit_v].double().mean()):.2f} and "
          f"{float(visits[1][hit_v].double().mean()):.2f}; bound "
          f"{bound_n[0]:.4f} ms ({bound_n[1]}: the walk reads "
          f"{touched_n / 1e6:.3f} MB of the tree's {tbl_bytes / 1e6:.3f}) "
          f"[{smi}]", flush=True)

    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    thr = torch.ones((3, lanes), device=dev)
    from raytrace_tpu_torch.render.integrator import surface_hit
    hit = surface_hit(tb_m, comps[0:3], comps[3:6], comps[6])
    sh_lanes = (*rays[0:6], *thr, alive.float())
    kw_s = dict(n_mats=tb_m.n_mats, n_targets=tb_m.n_targets,
                has_medium=False)
    s_call = lambda: shade_megakernel(tb_m.mtbl, tb_m.ttbl, hit, None,
                                      sh_lanes, uni, **kw_s)
    ms_s = _device_ms(s_call, "shade_kernel", 50)
    host_s = _time_ms(s_call, 50)
    plain_s = _time_ms(lambda: shade_plain(tb_m.mtbl, tb_m.ttbl, hit, None,
                                           sh_lanes, uni, **kw_s), 5, 1)
    bound_s = _bound_ms(4 * lanes * (10 + 10 + 8 + 15), lanes * 300)
    print(f"[time] shade kernel {ms_s:.4f} ms on the device ({host_s:.4f} ms "
          f"a call back to back) vs shade_plain {plain_s:.3f} ms at {lanes} "
          f"lanes; bound {bound_s[0]:.4f} ms ({bound_s[1]}) "
          f"[{smi}]", flush=True)

    # the mesh variant with every lane regenerating: its rays are the
    # camera rays of sample 0 of its pixels
    n_i = cfg["lanes"]
    tables, kw_i = iter_kernel_args(standin, s_fb, rng.base_key(1, dev), 15)
    lane_in = (pix_fb,) + fresh_carry(n_i, dev)
    c_i, _ = camera_rays(standin, s_m, n_i, 1, pixels=pix_fb)
    _, vis_i = allpairs_nearest_record(tb_m.ptbl, tb_m.bvh, *c_i.unbind(0),
                                       count_visits=True, **kw_n)
    i_call = lambda: iter_megakernel(*tables, lane_in, **kw_i)
    ms_i = _device_ms(i_call, "iter_kernel", 20)
    host_i = _time_ms(i_call, 20)
    plain_i = _time_ms(lambda: iter_plain(*tables, lane_in, **kw_i), 2, 1)
    nodes_i = float(vis_i[0].double().mean())
    rows_i = float(vis_i[1].double().mean())
    bound_i = _bound_ms(4 * n_i * (17 + 19) + tbl_bytes,
                        n_i * (450 + BOX_OPS * nodes_i + ROW_OPS * rows_i))
    print(f"[time] mesh iteration kernel {ms_i:.4f} ms on the device "
          f"({host_i:.4f} ms a call back to back) vs iter_plain "
          f"{plain_i:.3f} ms at {n_i} lanes (every lane regenerating; a ray "
          f"makes {nodes_i:.2f} box tests and {rows_i:.2f} row tests); bound "
          f"{bound_i[0]:.4f} ms ({bound_i[1]}) [{smi}]", flush=True)
    for line in ptxas_report():
        print(f"[ptxas] {line}", flush=True)

    phase_done("mesh kernel times")

    no_lib = None   # no single PyTorch call computes a nearest hit or shade
    kernels = [
        {"name": "allpairs_nearest_record", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/nearest_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/allpairs_kernel.py:920",
         "launches": r1_nearest, "max_abs_err": err_n, "ms": ms_n,
         "host_ms": host_n, "plain_ms": plain_n, "bound_ms": bound_n[0],
         "bound_by": bound_n[1], "library_ms": no_lib},
        {"name": "shade_megakernel", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/shade_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/bounce_kernel.py:616",
         "launches": r1_shade, "max_abs_err": err_s, "ms": ms_s,
         "host_ms": host_s, "plain_ms": plain_s, "bound_ms": bound_s[0],
         "bound_by": bound_s[1], "library_ms": no_lib},
        {"name": "iter_mega_ap", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/iter_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/iter_kernel.py:445",
         "launches": r2_iter, "max_abs_err": err_m, "ms": ms_i,
         "host_ms": host_i, "plain_ms": plain_i, "bound_ms": bound_i[0],
         "bound_by": bound_i[1], "library_ms": no_lib},
    ]
    summary = dict(route1=runs, route2=fb, bvh_build_s=tb_m.bvh.build_s,
                   visits=dict(box_tests=nodes_v, rows=rows_v))
    return dict(summary=summary, k5_launches=r2_k5, kernels=kernels)


def _rich_phases(smi, phase_done, dev) -> dict:
    """Phases 19-23 (rich textures) on ``dev``.  Returns the summary for
    the JSON line, the launches of the shade kernel, kernel B, its mesh
    variant and K5 on routes 3 and 4 and the textured mesh, and the
    ``kernels`` entries of K8, K12 and K13."""
    import numpy as np
    import torch
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.image_grad_kernel import (
        image_grad_pallas, image_grad_plain,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import (
        pallas_nearest_plain, pallas_nearest_record,
    )
    from raytrace_tpu_torch.ops.iter_kernel import iter_mega_ap, iter_megakernel
    from raytrace_tpu_torch.ops.texture_kernel import (
        marble_stripe_pallas, marble_stripe_plain, marble_table,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.integrator import split_tables
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        IMAGE_GRAD_FWD_BWD, MESH_FWD_BWD, bunny_tex_scene, camera_rays,
        checked_launches, compare_marble, compare_nearest_flat,
        compare_shade, image_grad_errs, image_grad_scene, marble_patterns,
        next_split_rays, noise_test_scene, plain_kernels, route_marble_lanes,
        stationary_lanes, surface_points,
    )
    from raytrace_tpu_torch.textures import textures as tex_mod
    counters = (bounce_megakernel, iter_megakernel, iter_mega_ap,
                allpairs_nearest_record, pallas_nearest_record,
                shade_megakernel, marble_stripe_pallas,
                bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
                image_grad_pallas)

    def reset():
        for c in counters:
            c.launches = 0

    def read():
        return {c.__name__: c.launches for c in counters}

    # 19. K8 and K12 vs plain on noise_test's camera lanes, two bounces
    noise, s_n = noise_test_scene(400, 100, 50, device=dev)
    n_pix, lanes, lane_pix = stationary_lanes(s_n)
    tb_n = split_tables(noise, s_n)
    comps, uni = camera_rays(noise, s_n, lanes, 71,
                             pixels=torch.from_numpy(lane_pix))
    thr = torch.ones((3, lanes), device=dev)
    alive = torch.ones(lanes, dtype=torch.bool, device=dev)
    marble_row = noise.textures.marble_rows[0]
    err8 = err12 = 0.0
    k8_rays = k12_in = None
    for depth in (0, 1):
        errs, _ = compare_nearest_flat(tb_n, comps)
        err8 = max(err8, _check(f"K8 vs plain: noise_test 400x225 "
                                f"({tb_n.n_prims} rows), bounce {depth + 1}",
                                errs, lanes))
        pts, hit = surface_points(tb_n, comps)
        tid = torch.where(alive, noise.materials.tex[hit[8].long()], -1)
        n_marble = int((tid == marble_row).sum())
        errs, _ = compare_marble(noise.textures, tid, pts)
        err12 = max(err12, _check(f"K12 vs plain: noise_test 400x225 bounce "
                                  f"{depth + 1}, {n_marble} marble lanes",
                                  errs, lanes))
        errs, out, _ = compare_shade(tb_n, comps, uni, thr, alive)
        _check(f"shade vs plain: noise_test 400x225 bounce {depth + 1}",
               errs, lanes)
        if err8 or err12 or n_marble == 0:
            raise AssertionError("K8 or K12 is not exact, or no lane hit "
                                 "the marble")
        if depth == 0:
            k8_rays, k12_in = tuple(comps.unbind(0)), (tid, pts, n_marble)
        comps, uni, thr, alive = next_split_rays(comps, out, 71, depth + 1)
    # K12 on the lanes the route hands it (the rich lanes compacted by
    # torch.nonzero) and on patterns beside a render's
    tid_r, pts_r = route_marble_lanes(noise, s_n, 72)
    cases = [("route's compacted rich lanes of noise_test",
              (noise.textures, tid_r, pts_r, None))]
    cases += [(name, (table, tid.to(dev), pts.to(dev), mtbl.to(dev)))
              for name, (table, tid, pts, mtbl)
              in marble_patterns(73, lanes).items()]
    for name, (table, tid, pts, mt) in cases:
        errs, _ = compare_marble(table, tid, pts, mt)
        n_m = int(torch.isin(tid.to(torch.float32),
                             (marble_table(table) if mt is None else mt)
                             [:, 0].to(tid.device)).sum())
        err12 = max(err12, _check(f"K12 vs plain: {name}, {n_m} marble "
                                  "lanes", errs, tid.shape[0]))
        if err12:
            raise AssertionError(f"K12 is not exact on {name}")
    phase_done("K8 and K12 vs plain")

    # 20. route 3: the rich forward at full size
    spp = s_n.samples_per_pixel
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(noise, s_n, seed=0, spp=spp)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r3 = read()
    l8, l10, l12 = (r3["pallas_nearest_record"], r3["shade_megakernel"],
                    r3["marble_stripe_pallas"])
    la, lb = r3["bounce_megakernel"], r3["iter_megakernel"]
    img = acc / total
    finite = bool(torch.isfinite(img).all())
    route3 = dict(seconds=dt, rays_per_s=n_pix * spp / dt, iterations=l8,
                  k8=l8, k10=l10, k12=l12, mean=float(img.mean()))
    print(f"[route 3] noise_test 400x225 {spp} spp depth 50 seed 0: "
          f"{dt:.3f} s, {n_pix * spp / dt / 1e6:.3f} M primary rays/s, {l8} "
          f"iterations ({1e3 * dt / max(l8, 1):.3f} ms/iter), launches "
          f"K8={l8} K10={l10} K12={l12} A={la} B={lb} K9="
          f"{r3['allpairs_nearest_record']}, mean {route3['mean']:.6f}, "
          f"finite {finite} [{smi}]", flush=True)
    if not finite or img.shape != (n_pix, 3) or l8 == 0 or l10 != l8 \
            or l12 == 0 or la or lb or r3["allpairs_nearest_record"]:
        raise AssertionError("route 3: bad image or launches")
    write_image(os.path.join(OUT_DIR, "noise_test.png"),
                img.reshape(s_n.image_height, s_n.image_width, 3))
    phase_done("route 3")
    with checked_launches() as stats:
        acc1, _ = render_accumulate(noise, s_n, seed=0, spp=1)
    for kname in ("pallas_nearest_record", "shade_megakernel",
                  "marble_stripe_pallas"):
        st = stats[kname]
        if st["launches"] == 0 or not bool(torch.isfinite(acc1).all()):
            raise AssertionError(f"checked route 3: {kname}")
        err = _check(f"route 3 checked: noise_test 400x225 1 spp, "
                     f"{st['launches']} launches of {kname}",
                     (st["n_int"], st["err"], st["excess"]), lanes)
        if err:
            raise AssertionError(f"checked route 3: {kname} is not exact")
    phase_done("checked route 3")

    # 21. route 4: the image-textured fwd+bwd
    cfg = IMAGE_GRAD_FWD_BWD
    img_scene, s_i = image_grad_scene(512, device=dev)
    n_pix_i = s_i.image_width * s_i.image_height
    params, statics = partition(img_scene)
    key = rng.base_key(0, dev)
    pix_i = (torch.arange(cfg["lanes"]) % n_pix_i).to(dev, torch.int32)
    tgt_i = torch.zeros((cfg["lanes"], 3), device=dev)

    def fwd_bwd():
        return loss_and_grads(params, statics, s_i, key, pix_i, tgt_i,
                              spp=cfg["spp"], n_iters=cfg["n_iters"],
                              remat=False)

    fwd_bwd()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    (loss, frac), grads = fwd_bwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r4 = read()
    peak = torch.cuda.max_memory_allocated()
    gnp = grads_to_numpy(grads)
    finite = all(bool(np.isfinite(x).all()) for x in gnp.values())
    atlas_l1 = float(np.abs(gnp["textures.images"]).sum())
    l13 = r4["image_grad_pallas"]
    route4 = dict(seconds=wall, rays_per_s=cfg["lanes"] * cfg["spp"] / wall,
                  loss=float(loss), samples_completed=float(frac),
                  launches_iter=r4["iter_megakernel"],
                  launches_bwd=r4["bounce_bwd_regen_pre_reduced"],
                  launches_k13=l13, atlas_grad_l1=atlas_l1, peak_bytes=peak)
    print(f"[route 4] image fwd+bwd 512x512, {cfg['lanes']} lanes x "
          f"{cfg['spp']} spp, rr2, {cfg['n_iters']} iterations: {wall:.3f} s, "
          f"{route4['rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
          f"{route4['loss']:.6f}, samples_completed {float(frac):.6f}, "
          f"launches B={r4['iter_megakernel']} "
          f"K5 reduced={r4['bounce_bwd_regen_pre_reduced']} "
          f"({_row_mode_name(img_scene)}) K5 per lane="
          f"{r4['bounce_bwd_regen_pre_megakernel']} K13={l13}, atlas "
          f"gradient L1 {atlas_l1:.6g}, peak memory {peak / 2**30:.3f} GiB, "
          f"gradients finite {finite} [{smi}]", flush=True)
    n_it = cfg["n_iters"]
    if not finite or float(frac) < 0.9999 or atlas_l1 <= 0.0 \
            or l13 != n_it - 1 or r4["iter_megakernel"] != n_it \
            or r4["bounce_bwd_regen_pre_reduced"] != n_it \
            or r4["bounce_bwd_regen_pre_megakernel"]:
        raise AssertionError("route 4: bad gradients, incomplete samples or "
                             "wrong launch counts")
    phase_done("route 4")

    # every K13 launch of route 4 against its plain version and a float64
    # sum; the launch with the most contributing lanes is kept for timing
    k13_in = None
    err13 = 0.0
    with checked_launches() as stats:
        inner = tex_mod.image_grad_pallas

        def keep(*a, **kw):
            nonlocal k13_in
            nz = int((a[3] != 0).any(1).sum())
            if k13_in is None or nz > k13_in[2]:
                k13_in = (a, kw, nz)
            return inner(*a, **kw)
        tex_mod.image_grad_pallas = keep
        try:
            fwd_bwd()
        finally:
            tex_mod.image_grad_pallas = inner
    st = stats["image_grad_pallas"]
    err13 = _check(f"K13 vs plain: route 4, {st['launches']} launches at "
                   f"{cfg['lanes']} lanes (tolerance: testing.image_grad_errs)",
                   (st["n_int"], st["err"], st["excess"]), cfg["lanes"])
    a13, kw13, nz13 = k13_in
    exact = image_grad_plain(*a13[:3], a13[3].to(torch.float64), **kw13)
    _, e64, x64 = image_grad_errs(*a13[:4], exact, image_grad_pallas(*a13,
                                                                      **kw13))
    print(f"[K13 vs float64] the launch with the most contributing lanes "
          f"({nz13} of {cfg['lanes']}): max |err| {e64:.3g}, worst excess "
          f"{x64:.3g}", flush=True)
    if st["launches"] != n_it - 1 or x64 > 0.0:
        raise AssertionError("K13 disagrees with a float64 sum")

    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix_i // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=4, n_iters=24, remat=False)
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_i, key, pix9, tgt9,
                                     **kw9)
    with plain_kernels():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_i, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max((float(np.abs(g_k[k] - g_p[k]).max())
                 / max(float(np.abs(g_p[k]).max()), 1e-30), k) for k in g_p)
    print(f"[route 4 kernels vs plain] {n9} lanes, 4 spp, 24 iterations: "
          f"loss {float(l_k):.6f} vs {float(l_p):.6f}, samples "
          f"{float(f_k):.4f} vs {float(f_p):.4f}, worst leaf "
          f"max|diff|/max|plain| {worst[0]:.3g} ({worst[1]}; atlas "
          f"{float(np.abs(g_k['textures.images'] - g_p['textures.images']).max()) / max(float(np.abs(g_p['textures.images']).max()), 1e-30):.3g})"
          f" (bound {GRAD_RTOL})", flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst[0] <= GRAD_RTOL:
        raise AssertionError("route 4: the kernels and their plain versions "
                             "disagree")

    s_fd = s_i.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=4, n_iters=40, remat=False)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex = img_scene.textures
    ga = g_fd.textures.images[0, :, :, 1].abs()
    texel = tuple(int(x) for x in np.unravel_index(int(torch.argmax(ga)),
                                                   tuple(ga.shape)))
    idx = (0, *texel, 1)

    def loss_at(x):
        im = tex.images.clone()
        im[idx] = x[0]
        sc = dataclasses.replace(img_scene,
                                 textures=dataclasses.replace(tex, images=im))
        with torch.no_grad():
            return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                         tgt_fd, **kw_fd)[0]
    # the loss is quadratic in one texel under the exact estimator, so a
    # wide step costs no accuracy and lifts the change above the f32
    # rounding of the loss
    fd = float(finite_difference(loss_at, tex.images[idx].reshape(1).clone(),
                                 0.25)[0])
    gv = float(g_fd.textures.images[idx])
    print(f"[finite difference] atlas texel {idx} (green): gradient "
          f"{gv:.6g}, central difference {fd:.6g} (eps 0.25), rel diff "
          f"{abs(gv - fd) / abs(fd):.3g} (bound {FD_RTOL})", flush=True)
    if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
        raise AssertionError("finite difference: atlas texel")
    phase_done("route 4 checks")

    # 22. the textured bunny stand-in's fwd+bwd
    cfg_b = MESH_FWD_BWD
    bunny, s_b = bunny_tex_scene(600, device=dev)
    n_pix_b = s_b.image_width * s_b.image_height
    params_b, statics_b = partition(bunny)
    pix_b = (torch.arange(cfg_b["lanes"]) % n_pix_b).to(dev, torch.int32)
    tgt_b = torch.zeros((cfg_b["lanes"], 3), device=dev)

    def fwd_bwd_b():
        return loss_and_grads(params_b, statics_b, s_b, key, pix_b, tgt_b,
                              spp=cfg_b["spp"], n_iters=cfg_b["n_iters"],
                              remat=False, schedule=cfg_b["schedule"])

    fwd_bwd_b()                                 # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    (loss_b, frac_b), grads_b = fwd_bwd_b()
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    rb = read()
    gnp_b = grads_to_numpy(grads_b)
    finite_b = all(bool(np.isfinite(x).all()) for x in gnp_b.values())
    n_exp = cfg_b["n_iters"] + sum(i for i, _ in cfg_b["schedule"])
    bunny_fb = dict(seconds=wall_b,
                    rays_per_s=cfg_b["lanes"] * cfg_b["spp"] / wall_b,
                    samples_completed=float(frac_b),
                    launches_iter=rb["iter_mega_ap"],
                    launches_bwd=rb["bounce_bwd_regen_pre_reduced"],
                    launches_k13=rb["image_grad_pallas"])
    print(f"[textured mesh fwd+bwd] stand-in with a 128x256 image, "
          f"{cfg_b['lanes']} lanes x {cfg_b['spp']} spp: {wall_b:.3f} s, "
          f"{bunny_fb['rays_per_s'] / 1e6:.3f} M primary rays/s, "
          f"samples_completed {float(frac_b):.6f}, launches mesh iteration="
          f"{rb['iter_mega_ap']} K5 reduced="
          f"{rb['bounce_bwd_regen_pre_reduced']} ({_row_mode_name(bunny)}) "
          f"K5 per lane="
          f"{rb['bounce_bwd_regen_pre_megakernel']} "
          f"K13={rb['image_grad_pallas']}, atlas gradient L1 "
          f"{float(np.abs(gnp_b['textures.images']).sum()):.6g}, gradients "
          f"finite {finite_b} [{smi}]", flush=True)
    if not finite_b or rb["iter_mega_ap"] != n_exp \
            or rb["bounce_bwd_regen_pre_reduced"] != n_exp \
            or rb["bounce_bwd_regen_pre_megakernel"] \
            or rb["image_grad_pallas"] == 0:
        raise AssertionError("textured mesh fwd+bwd: bad gradients or "
                             "launch counts")
    phase_done("textured mesh fwd+bwd")

    # 23. kernel times at the slice's shapes
    kw_n = dict(n_prims=tb_n.n_prims, t_min=tb_n.t_min,
                has_motion=tb_n.has_motion)
    k8_call = lambda: pallas_nearest_record(tb_n.ptbl, *k8_rays, **kw_n)
    ms8 = _device_ms(k8_call, "nearest_flat_kernel", 50)
    call8 = _time_ms(k8_call, 50)
    plain8 = _time_ms(lambda: pallas_nearest_plain(tb_n.ptbl, *k8_rays,
                                                   **kw_n), 5, 1)
    bound8 = _bound_ms(4 * lanes * (7 + 9) + 4 * 36 * tb_n.n_prims,
                       lanes * ROW_OPS * tb_n.n_prims)
    print(f"[time] K8 {ms8:.4f} ms on the device ({call8:.4f} ms a call "
          f"back to back) vs pallas_nearest_plain {plain8:.3f} ms at "
          f"{lanes} camera rays of noise_test ({tb_n.n_prims} rows); bound "
          f"{bound8[0]:.4f} ms ({bound8[1]}) [{smi}]", flush=True)
    tid0, pts0, nm0 = k12_in
    mtbl = marble_table(noise.textures)
    k12_call = lambda: marble_stripe_pallas(noise.textures, tid0, pts0, mtbl)
    ms12 = _device_ms(k12_call, "marble_kernel", 50)
    call12 = _time_ms(k12_call, 50)
    plain12 = _time_ms(lambda: marble_stripe_plain(noise.textures, tid0,
                                                   pts0, mtbl), 5, 1)
    bound12 = _bound_ms(4 * lanes * (1 + 3 + 1) + 4 * mtbl.numel(),
                        nm0 * MARBLE_OPS)
    print(f"[time] K12 {ms12:.4f} ms on the device ({call12:.4f} ms a call "
          f"back to back) vs marble_stripe_plain {plain12:.3f} ms at {lanes} "
          f"lanes ({nm0} marble); bound {bound12[0]:.4f} ms "
          f"({bound12[1]}, {MARBLE_OPS} operations a marble lane) [{smi}]",
          flush=True)
    sass12 = _marble_sass_count()
    print(f"[sass] K12: {sass12}; ptxas: "
          f"{' | '.join(ptxas_report(('marble_kernel',)))} [{smi}]",
          flush=True)
    a13i = tuple(x.to(torch.int32) for x in a13[:3]) + (a13[3],)
    k13_call = lambda: image_grad_pallas(*a13i, **kw13)
    ms13 = _device_ms(k13_call, "image_grad_kernel", 50)
    call13 = _time_ms(k13_call, 50)
    plain13 = _time_ms(lambda: image_grad_plain(*a13, **kw13), 20)
    idx13 = tuple(x.long() for x in a13[:3])
    shape13 = (kw13["n_img"], kw13["h"], kw13["w"], 3)
    lib13 = _time_ms(lambda: torch.zeros(shape13, device=dev).index_put_(
        idx13, a13[3], accumulate=True), 20)
    n13 = a13[3].shape[0]
    bound13 = _bound_ms(n13 * (3 * 4 + 3 * 4) + 4 * int(np.prod(shape13)),
                        3 * nz13)
    print(f"[time] K13 {ms13:.4f} ms on the device ({call13:.4f} ms a call "
          f"back to back) vs image_grad_plain {plain13:.4f} ms vs "
          f"index_put_(accumulate=True) {lib13:.4f} ms at {n13} lanes "
          f"({nz13} contributing) into a {shape13} atlas; bound "
          f"{bound13[0]:.5f} ms ({bound13[1]}) [{smi}]", flush=True)
    phase_done("rich kernel times")

    kernels = [
        {"name": "pallas_nearest_record", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/nearest_flat_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/intersect_kernel.py:1026",
         "launches": l8, "max_abs_err": err8, "ms": ms8, "host_ms": call8,
         "plain_ms": plain8, "bound_ms": bound8[0], "bound_by": bound8[1],
         "library_ms": None},
        {"name": "marble_stripe_pallas", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/texture_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/texture_kernel.py:89",
         "launches": l12, "max_abs_err": err12, "ms": ms12,
         "host_ms": call12, "plain_ms": plain12, "bound_ms": bound12[0],
         "bound_by": bound12[1], "library_ms": None},
        {"name": "image_grad_pallas", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/image_grad_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/image_grad_kernel.py:110",
         "launches": l13 + rb["image_grad_pallas"],
         "max_abs_err": max(err13, e64), "ms": ms13, "host_ms": call13,
         "plain_ms": plain13,
         "bound_ms": bound13[0], "bound_by": bound13[1],
         "library_ms": lib13},
    ]
    summary = dict(route3=route3, route4=route4, textured_mesh=bunny_fb)
    return dict(summary=summary, kernels=kernels, shade_launches=l10,
                iter_launches=r4["iter_megakernel"],
                mesh_iter_launches=rb["iter_mega_ap"],
                k5_launches=r4["bounce_bwd_regen_pre_reduced"]
                + rb["bounce_bwd_regen_pre_reduced"])


def _media_phases(smi, phase_done, dev) -> dict:
    """Phases 24-28 (constant-density media) on ``dev``.  Returns the
    summary for the JSON line, the launches of K8, K9 and the shade kernel
    on routes 5-7, and the ``kernels`` entries of K11 and K11b."""
    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
        volume_candidates_plain, volume_crossings_plain,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.render.volumes import (
        crossing_kw, medium_hit, volume_crossings, volume_tables,
    )
    from raytrace_tpu_torch.testing import (
        CAND_ULPS, MIXED_MEDIA_INSIDE, checked_launches, compare_crossings,
        compare_medium_hit, cornell_smoke_scene, general_tables,
        media_bounce_rays, mixed_media_world, pawn_inside_rays,
        pawn_standin_scene, scatter_draws, stationary_lanes, uv_sphere,
        volume_rays, volume_test_world,
    )
    counters = (bounce_megakernel, iter_megakernel, pallas_nearest_record,
                allpairs_nearest_record, shade_megakernel,
                pallas_volume_crossings, pallas_volume_crossings_bcast)
    modes = (pallas_volume_crossings, pallas_volume_crossings_bcast)

    def reset():
        for c in counters:
            c.launches = 0
        for c in modes:
            c.candidate_launches = 0
        pallas_volume_crossings.planar_launches = 0

    def read():
        got = {c.__name__: c.launches for c in counters}
        for c in modes:
            got[c.__name__ + ".candidate"] = c.candidate_launches
        got["pallas_volume_crossings.planar"] = \
            pallas_volume_crossings.planar_launches
        return got

    def check_crossings(label, volumes, comps, **kw):
        errs, out = compare_crossings(volumes, comps, **kw)
        inside = [int(((out[3 * v + 1] == 0.0) & torch.isfinite(out[3 * v]))
                      .sum()) for v in range(volumes.n_volumes)]
        err = _check(f"{label}; lanes whose first crossing exits, per "
                     f"medium: {inside}", errs, comps.shape[1])
        if err:
            raise AssertionError(f"{label}: not exact")
        return err

    def check_candidates(label, volumes, comps, tables, seed):
        """The candidate mode (medium_hit over ``tables``' launches)
        against its plain version on the rays ``comps`` with draws from
        ``seed``: the material id and which lanes scatter equal on every
        lane, t_med within CAND_ULPS."""
        u = scatter_draws(volumes.n_volumes, comps.shape[1], seed,
                          device=dev)
        (n_int, err, ulps), out = compare_medium_hit(volumes, comps, u,
                                                     tables=tables)
        print(f"[{label}] {comps.shape[1]} lanes, "
              f"{int(torch.isfinite(out[0]).sum())} scatter: material id or "
              f"scattering differ on {n_int} lanes, t_med max |err| "
              f"{err:.3g}, {ulps} ulps (tolerance {CAND_ULPS})", flush=True)
        if n_int or ulps > CAND_ULPS:
            raise AssertionError(f"{label}: candidate mode disagrees")
        return err

    smoke, s_s = cornell_smoke_scene(600, FWD_SPP, 50, device=dev)
    pawn, s_p = pawn_standin_scene(500, PAWN_SPP, 20, device=dev)
    n_pix_s, lanes_s, _ = stationary_lanes(s_s)
    n_pix_p = s_p.image_width * s_p.image_height
    print(f"[media] cornell_smoke: {smoke.prims.n} surface rows, media of "
          f"{smoke.volumes.counts} boundary rows; pawn stand-in: "
          f"{pawn.prims.n} triangles in {pawn.prims.kind.shape[0]} rows "
          f"(segments {pawn.prims.kind_segments}), a medium of "
          f"{pawn.volumes.counts} boundary rows", flush=True)

    # 24. the crossing kernels vs plain: K11 in both instantiations (its
    # general one unprepared too), and the candidate mode of K11 and K11b
    err11 = err11b = err11c = err11bc = 0.0
    tables_s = volume_tables(smoke.volumes)
    if [x.planar for x in tables_s.launches] != [True]:
        raise AssertionError("cornell_smoke's boundary is not planar")
    general_s = general_tables(tables_s)
    smoke_rays = media_bounce_rays(smoke, s_s, 81)
    for k, (comps, alive) in enumerate(smoke_rays):
        what = f"cornell_smoke 600x600 bounce {k + 1} ({int(alive.sum())} live)"
        for label, kw in (("general, unprepared", {}),
                          ("planar", dict(tables=tables_s, prepared=True)),
                          ("general", dict(tables=general_s,
                                           prepared=True))):
            err11 += check_crossings(f"K11 {label} vs plain: {what}",
                                     smoke.volumes, comps, **kw)
        for label, tb in (("planar", tables_s), ("general", general_s)):
            err11c = max(err11c, check_candidates(
                f"K11 candidate mode, {label}, vs plain: {what}",
                smoke.volumes, comps, tb, 90 + k))
    n_k = 1 << 17
    pix_p = (torch.arange(n_k) * n_pix_p // n_k).to(dev, torch.int32)
    pawn_rays = media_bounce_rays(pawn, s_p, 82, pixels=pix_p)
    tables_p = volume_tables(pawn.volumes)
    inside_p = pawn_inside_rays(n_k, 83, device=dev)
    for k, (label, comps) in enumerate(
            [(f"bounce {k + 1} ({int(alive.sum())} live)", comps)
             for k, (comps, alive) in enumerate(pawn_rays)]
            + [("rays from inside the medium", inside_p)]):
        err11b += check_crossings(f"K11b vs plain: pawn stand-in 500x500 "
                                  f"{label}", pawn.volumes, comps)
        err11bc = max(err11bc, check_candidates(
            f"K11b candidate mode vs plain: pawn stand-in 500x500 {label}",
            pawn.volumes, comps, tables_p, 92 + k))
    for moving in (False, True):
        world = rt.compile_scene(volume_test_world(rt, moving), device=dev)
        comps = volume_rays(1 << 16, 84 + moving, (-6.0, 6.0),
                            ([0.0, 0.0, -3.0], [3.2, 0.0, -3.5]), device=dev)
        what = (f"fog ball and smoke box{' moving' if moving else ''} (a box "
                f"row), random rays")
        tb = volume_tables(world.volumes)
        for label, kw in (("general, unprepared", {}),
                          ("general", dict(tables=tb, prepared=True))):
            err11 += check_crossings(f"K11 {label} vs plain: {what}",
                                     world.volumes, comps, **kw)
        err11c = max(err11c, check_candidates(
            f"K11 candidate mode, general, vs plain: {what}", world.volumes,
            comps, tb, 95 + moving))
        world = rt.compile_scene(mixed_media_world(rt, moving), device=dev)
        comps = volume_rays(1 << 16, 86 + moving, (-6.0, 6.0),
                            MIXED_MEDIA_INSIDE, device=dev)
        what = (f"four media of {world.volumes.counts} rows"
                f"{', moving' if moving else ''} (a mesh, a ball, a box row, "
                f"a small mesh), random rays")
        err11b += check_crossings(f"K11b vs plain: {what}", world.volumes,
                                  comps)
        err11bc = max(err11bc, check_candidates(
            f"K11b candidate mode vs plain: {what}", world.volumes, comps,
            volume_tables(world.volumes), 97 + moving))
    phase_done("crossing kernels vs plain")

    # 25. route 5: the media forward at full size
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(smoke, s_s, seed=0, spp=FWD_SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r5 = read()
    l8, l10, l11 = (r5["pallas_nearest_record"], r5["shade_megakernel"],
                    r5["pallas_volume_crossings"])
    others = (r5["bounce_megakernel"], r5["iter_megakernel"],
              r5["allpairs_nearest_record"],
              r5["pallas_volume_crossings_bcast"])
    img = acc / total
    finite = bool(torch.isfinite(img).all())
    route5 = dict(seconds=dt, rays_per_s=n_pix_s * FWD_SPP / dt,
                  iterations=l8, k8=l8, k10=l10, k11=l11,
                  mean=float(img.mean()))
    print(f"[route 5] cornell_smoke 600x600 {FWD_SPP} spp (the scene renders "
          f"200) depth 50 seed 0: {dt:.3f} s, "
          f"{route5['rays_per_s'] / 1e6:.3f} M primary rays/s, {l8} "
          f"iterations ({1e3 * dt / max(l8, 1):.3f} ms/iter), launches "
          f"K8={l8} K10={l10} K11={l11} (planar "
          f"{r5['pallas_volume_crossings.planar']}, candidate mode "
          f"{r5['pallas_volume_crossings.candidate']}) A={others[0]} "
          f"B={others[1]} K9={others[2]} K11b={others[3]}, mean "
          f"{route5['mean']:.6f}, "
          f"finite {finite} [{smi}]", flush=True)
    if not finite or img.shape != (n_pix_s, 3) or l8 == 0 or l10 != l8 \
            or l11 != l8 or any(others) \
            or r5["pallas_volume_crossings.planar"] != l11 \
            or r5["pallas_volume_crossings.candidate"] != l11:
        raise AssertionError("route 5: bad image or launches (every K11 "
                             "launch must be planar, in the candidate mode)")
    write_image(os.path.join(OUT_DIR, "cornell_smoke.png"),
                img.reshape(s_s.image_height, s_s.image_width, 3))
    phase_done("route 5")
    with checked_launches() as stats:
        acc1, _ = render_accumulate(smoke, s_s, seed=0, spp=1)
    for kname in ("pallas_nearest_record", "pallas_volume_candidates",
                  "shade_megakernel"):
        st = stats[kname]
        if st["launches"] == 0 or not bool(torch.isfinite(acc1).all()):
            raise AssertionError(f"checked route 5: {kname}")
        cand = kname == "pallas_volume_candidates"
        err = _check(f"route 5 checked: cornell_smoke 600x600 1 spp, "
                     f"{st['launches']} launches of {kname}"
                     f"{' (t_med ulps within CAND_ULPS)' if cand else ''}",
                     (st["n_int"], st["err"], st["excess"]), lanes_s)
        if (st["excess"] > 0) if cand else err:
            raise AssertionError(f"checked route 5: {kname} is not exact")
        if cand:
            err11c = max(err11c, err)
    if stats["pallas_volume_crossings"]["launches"]:
        raise AssertionError("checked route 5: the crossings mode launched")
    phase_done("checked route 5")

    # 26. route 6: the mesh-boundary medium through the sorted driver
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(pawn, s_p, seed=0, spp=PAWN_SPP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r6 = read()
    l9, l10p, l11b = (r6["allpairs_nearest_record"], r6["shade_megakernel"],
                      r6["pallas_volume_crossings_bcast"])
    others = (r6["bounce_megakernel"], r6["iter_megakernel"],
              r6["pallas_nearest_record"], r6["pallas_volume_crossings"])
    img = acc / total
    finite = bool(torch.isfinite(img).all())
    route6 = dict(seconds=dt, rays_per_s=n_pix_p * PAWN_SPP / dt,
                  iterations=l9, k9=l9, k10=l10p, k11b=l11b,
                  mean=float(img.mean()))
    print(f"[route 6] pawn stand-in 500x500 {PAWN_SPP} spp (the scene "
          f"renders 400) depth 20 seed 0, sorted driver: {dt:.3f} s, "
          f"{route6['rays_per_s'] / 1e6:.3f} M primary rays/s, {l9} "
          f"iterations ({1e3 * dt / max(l9, 1):.3f} ms/iter), launches "
          f"K9={l9} K11b={l11b} K10={l10p} A={others[0]} B={others[1]} "
          f"K8={others[2]} K11={others[3]}, mean {route6['mean']:.6f}, "
          f"finite {finite} [{smi}]", flush=True)
    if not finite or img.shape != (n_pix_p, 3) or l9 == 0 or l10p != l9 \
            or l11b != l9 or any(others) \
            or r6["pallas_volume_crossings_bcast.candidate"] != l11b:
        raise AssertionError("route 6: bad image or launches (every K11b "
                             "launch in the candidate mode)")
    write_image(os.path.join(OUT_DIR, "pawn_standin.png"),
                img.reshape(s_p.image_height, s_p.image_width, 3))
    phase_done("route 6")
    small, s_small = pawn_standin_scene(128, 1, 20, device=dev)
    with checked_launches() as stats:
        acc1, _ = render_accumulate(small, s_small, seed=0, spp=1)
    for kname in ("allpairs_nearest_record", "pallas_volume_candidates_bcast",
                  "shade_megakernel"):
        st = stats[kname]
        if st["launches"] == 0 or not bool(torch.isfinite(acc1).all()):
            raise AssertionError(f"checked route 6: {kname}")
        cand = kname == "pallas_volume_candidates_bcast"
        err = _check(f"route 6 checked: pawn stand-in 128x128 1 spp, "
                     f"{st['launches']} launches of {kname}"
                     f"{' (t_med ulps within CAND_ULPS)' if cand else ''}",
                     (st["n_int"], st["err"], st["excess"]), 128 * 128)
        if (st["excess"] > 0) if cand else err:
            raise AssertionError(f"checked route 6: {kname} is not exact")
        if cand:
            err11bc = max(err11bc, err)
    phase_done("checked route 6")

    # 27. the 50,000-triangle sphere through the sorted driver
    v, f = uv_sphere(126, 200)
    big = rt.compile_scene(rt.with_material(
        rt.lambertian(rt.constant_texture([0.6, 0.6, 0.6])),
        rt.triangle_mesh(rt.Mesh(1.5 * v, np.zeros((0, 2)), f,
                                 np.full_like(f, -1)))), device=dev)
    s_big = rt.CameraSettings(center=[0.0, 1.0, 4.0], look_at=[0.0, 0.0, 0.0],
                              image_width=256, max_depth=10,
                              background=rt.gray_fade)
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, total = render_accumulate(big, s_big, seed=0, spp=4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r7 = read()
    l9b, l10b = r7["allpairs_nearest_record"], r7["shade_megakernel"]
    finite = bool(torch.isfinite(acc).all())
    route7 = dict(seconds=dt, rays_per_s=256 * 256 * 4 / dt, iterations=l9b,
                  mean=float((acc / total).mean()))
    print(f"[route 7] {f.shape[0]}-triangle sphere ({big.prims.kind.shape[0]}"
          f" rows) 256x256 4 spp depth 10, sorted driver: {dt:.3f} s, "
          f"{route7['rays_per_s'] / 1e6:.3f} M primary rays/s, launches "
          f"K9={l9b} K10={l10b} A={r7['bounce_megakernel']} "
          f"B={r7['iter_megakernel']}, mean {route7['mean']:.6f}, finite "
          f"{finite} [{smi}]", flush=True)
    if not finite or l9b == 0 or l10b != l9b:
        raise AssertionError("route 7: bad image or launches")
    phase_done("50k-triangle sphere, sorted")

    # 28. kernel times at the slice's shapes.  K11: the route's launch
    # (planar, candidate mode, through medium_hit as the bounce calls it)
    # and the crossings mode in both instantiations, on the camera rays;
    # registers and the SASS instructions of each instantiation's row loop
    # (operations a ray and row for the bound: one an instruction)
    vtbl_s = tables_s.vtbl
    kw_s = crossing_kw(smoke.volumes, s_s.t_min)
    rays_s = tuple(smoke_rays[0][0].unbind(0))
    nv_s = smoke.volumes.n_volumes
    rows_s = vtbl_s.shape[0]
    u_s = scatter_draws(nv_s, lanes_s, 99, device=dev)
    inf_s = torch.full((lanes_s,), float("inf"), device=dev)
    zero_s = torch.zeros(lanes_s, device=dev)
    calls = {
        "candidate": lambda: medium_hit(smoke.volumes, rays_s, s_s.t_min,
                                        u_s, tables_s),
        "crossings": lambda: volume_crossings(smoke.volumes, rays_s,
                                              s_s.t_min, tables_s),
        "crossings_general": lambda: volume_crossings(
            smoke.volumes, rays_s, s_s.t_min, general_s),
        "crossings_unprepared": lambda: pallas_volume_crossings(
            vtbl_s, *rays_s, **kw_s)}
    t11 = {k: (_device_ms(fn, "volume_crossings_kernel", 50),
               _time_ms(fn, 50)) for k, fn in calls.items()}
    plain11 = _time_ms(lambda: volume_crossings_plain(vtbl_s, *rays_s,
                                                      **kw_s), 5, 1)
    plain11c = _time_ms(lambda: volume_candidates_plain(
        vtbl_s, *rays_s, u=u_s, t_med=inf_s, vmat=zero_s,
        density=smoke.volumes.density, mats=smoke.volumes.mat.tolist(),
        **kw_s), 5, 1)
    for line in ptxas_report(("volume_crossings_kernel",)):
        print(f"[ptxas] {line}", flush=True)
    row_ins = {}
    per_k = source_constant("volume_kernel", "kRays")
    for name, count in inner_loop_sizes("volume_kernel",
                                        "volume_crossings_kernel"):
        flags = re.search(r"volume_crossings_kernelILb(\d)ELb(\d)ELb(\d)E"
                          r"Lb(\d)ELb(\d)E", name)
        if flags is None or flags.group(5) == "1":   # the keyed mode: 35
            continue
        planar, motion, box, cand = (int(x) for x in flags.groups()[:4])
        row_ins[(planar, motion, box, cand)] = count / per_k
        print(f"[sass] K11 {'planar' if planar else 'general'}"
              f"{' motion' if motion else ''}{' box' if box else ''}, "
              f"{'candidate' if cand else 'crossings'} mode: row loop "
              f"{count} instructions for {per_k} rays, {count / per_k:.1f} a "
              f"ray and row", flush=True)
    if (1, 0, 0, 1) not in row_ins or (1, 0, 0, 0) not in row_ins:
        raise AssertionError(f"K11's planar row loops not found in its SASS "
                             f"(found {sorted(row_ins)})")
    ops_row, ops_row_x = row_ins[(1, 0, 0, 1)], row_ins[(1, 0, 0, 0)]
    # bytes: the six ray columns (no motion: no time), the table; the
    # candidate mode reads V draws and writes the fold's two rows (one
    # group, phase 24 checks it: the launch starts the fold, reading no
    # rows), the crossings mode writes 3V rows
    bound11 = _bound_ms(4 * lanes_s * (6 + nv_s + 2) + 4 * vtbl_s.numel(),
                        lanes_s * rows_s * ops_row)
    bound11x = _bound_ms(4 * lanes_s * (6 + 3 * nv_s) + 4 * vtbl_s.numel(),
                         lanes_s * rows_s * ops_row_x)
    ms11, back11 = t11["candidate"]
    print(f"[time] K11 (planar, {per_k} rays a thread) at {lanes_s} camera "
          f"rays of cornell_smoke ({rows_s} boundary rows, all tested), ms "
          f"on the device / a call back to back: candidate mode through "
          f"medium_hit {ms11:.4f} / {back11:.4f} vs volume_candidates_plain "
          f"{plain11c:.3f}, bound {bound11[0]:.4f} ({bound11[1]}, "
          f"{ops_row:.1f} operations a row); crossings mode "
          f"{t11['crossings'][0]:.4f} / {t11['crossings'][1]:.4f}, general "
          f"{t11['crossings_general'][0]:.4f} / "
          f"{t11['crossings_general'][1]:.4f}, unprepared (general) "
          f"{t11['crossings_unprepared'][0]:.4f} / "
          f"{t11['crossings_unprepared'][1]:.4f} vs volume_crossings_plain "
          f"{plain11:.3f}, bound {bound11x[0]:.4f} ({bound11x[1]}, "
          f"{ops_row_x:.1f} operations a row) [{smi}]", flush=True)
    vtbl_p, forest_p = tables_p.vtbl, tables_p.forest
    kw_p = crossing_kw(pawn.volumes, s_p.t_min)
    rays_p = tuple(pawn_rays[0][0].unbind(0))
    call11b = lambda: pallas_volume_crossings_bcast(vtbl_p, forest_p,
                                                    *rays_p, **kw_p)
    ms11b = _device_ms(call11b, "volume_bvh_kernel", 50)
    back11b = _time_ms(call11b, 50)
    u_p = scatter_draws(1, rays_p[0].shape[0], 98, device=dev)
    call11bc = lambda: medium_hit(pawn.volumes, rays_p, s_p.t_min, u_p,
                                  tables_p)
    ms11bc = _device_ms(call11bc, "volume_bvh_kernel", 50)
    back11bc = _time_ms(call11bc, 50)
    plain11b = _time_ms(lambda: volume_crossings_plain(vtbl_p, *rays_p,
                                                       **kw_p), 2, 1)
    # the walk's work and its bound for the camera rays and for rays from
    # inside the medium: the rays read and written once, the nodes and
    # leaf-ordered rows read once, BOX_OPS a box test and VOL_ROW_OPS a
    # row test; beside it the bound of the 256-row chunk scan it replaced
    # at that scan's measured work (CHUNK_ROWS_A_RAY rows and 5 chunk
    # boxes a camera ray)
    walk_bytes = 4 * (forest_p.nodes.numel() + forest_p.rows.numel())
    works = {}
    for label, comps in (("camera", pawn_rays[0][0]),
                         ("inside", pawn_inside_rays(n_k, 83, device=dev))):
        _, visits = pallas_volume_crossings_bcast(
            vtbl_p, forest_p, *comps.unbind(0), count_visits=True, **kw_p)
        v = visits.double()
        warp = v.view(2, -1, 32).amax(2)
        bound = _bound_ms(4 * n_k * (7 + 3) + walk_bytes,
                          float(v[0].sum()) * BOX_OPS
                          + float(v[1].sum()) * VOL_ROW_OPS)
        works[label] = dict(box_tests=float(v[0].mean()),
                            row_tests=float(v[1].mean()),
                            warp_max_box_tests=float(warp[0].mean()),
                            warp_max_row_tests=float(warp[1].mean()),
                            bound_ms=bound[0], bound_by=bound[1])
        print(f"[visits] K11b on {n_k} {label} rays of the pawn stand-in: "
              f"{works[label]['box_tests']:.3f} box tests and "
              f"{works[label]['row_tests']:.3f} row tests a ray (the "
              "slowest lane of a warp: "
              f"{works[label]['warp_max_box_tests']:.3f} and "
              f"{works[label]['warp_max_row_tests']:.3f}); bound "
              f"{bound[0]:.5f} ms ({bound[1]}) [{smi}]", flush=True)
    bound11b = (works["camera"]["bound_ms"], works["camera"]["bound_by"])
    old_bound = _bound_ms(4 * n_k * (7 + 3) + 4 * vtbl_p.numel(),
                          n_k * (VOL_ROW_OPS * CHUNK_ROWS_A_RAY
                                 + VOL_BOX_OPS * 5))
    print(f"[time] K11b {ms11b:.4f} ms on the device ({back11b:.4f} ms a call "
          f"back to back) vs volume_crossings_plain {plain11b:.3f} ms at "
          f"{n_k} camera rays of the pawn stand-in ("
          f"{'triangle-only' if forest_p.tri_only else 'general'} walk, "
          f"{forest_p.nodes.shape[0]} nodes, depth {forest_p.depth}, built "
          f"in {forest_p.build_s:.4f} s); bound {bound11b[0]:.5f} ms "
          f"({bound11b[1]}), the chunk scan's at its {CHUNK_ROWS_A_RAY} rows "
          f"a ray {old_bound[0]:.5f} ms ({old_bound[1]}); the route's "
          f"candidate mode through medium_hit {ms11bc:.4f} ms on the device "
          f"({back11bc:.4f} ms a call) [{smi}]", flush=True)
    phase_done("crossing kernel times")

    kernels = [
        {"name": "pallas_volume_crossings", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/volume_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/volume_kernel.py:594",
         "launches": l11, "max_abs_err": max(err11, err11c), "ms": ms11,
         "host_ms": back11, "plain_ms": plain11c, "bound_ms": bound11[0],
         "bound_by": bound11[1], "library_ms": None,
         "mode": "candidate, planar", "crossings_ms": t11["crossings"][0],
         "crossings_host_ms": t11["crossings"][1],
         "crossings_general_ms": t11["crossings_general"][0],
         "crossings_unprepared_host_ms": t11["crossings_unprepared"][1],
         "crossings_plain_ms": plain11, "crossings_bound_ms": bound11x[0],
         "row_instructions": ops_row},
        {"name": "pallas_volume_crossings_bcast", "route": "cuda",
         "source": "raytrace_tpu_torch/csrc/volume_kernel.cu",
         "replaces": "raytrace_tpu/ops/pallas/volume_kernel.py:514",
         "launches": l11b, "max_abs_err": max(err11b, err11bc),
         "ms": ms11b,
         "host_ms": back11b, "plain_ms": plain11b, "bound_ms": bound11b[0],
         "bound_by": bound11b[1], "library_ms": None,
         "box_tests": works["camera"]["box_tests"],
         "row_tests": works["camera"]["row_tests"],
         "candidate_ms": ms11bc, "candidate_host_ms": back11bc},
    ]
    summary = dict(route5=route5, route6=route6, route7=route7,
                   k11b_work=works)
    return dict(summary=summary, kernels=kernels, k8_launches=l8,
                k9_launches=l9 + l9b, shade_launches=l10 + l10p + l10b)


def _unfused_phases(smi, phase_done, dev) -> dict:
    """Phases 29-34 (the unfused differentiable wavefront and F8's
    17-medium forward) on ``dev``.  Returns the summary for the JSON line,
    the launches of kernel A, K8, K11, K11b and the shade kernel on routes
    8, 9 and the 17-medium renders, and the ``kernels`` entry of K7."""
    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        finite_difference, loss_and_grads, partition, render_loss_wavefront,
    )
    from raytrace_tpu_torch.interop import grads_to_numpy
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_bwd_kernel import (
        bounce_bwd_megakernel, bounce_bwd_megakernel_reduced,
        bounce_bwd_megakernel_reduced_plain,
    )
    from raytrace_tpu_torch.ops.row_reduce import row_tables
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.volume_kernel import pallas_volume_crossings
    from raytrace_tpu_torch.render.integrator import (
        lane_cost_estimate, trace_wavefront_diff,
    )
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        ALL_MATERIAL_TARGETS, BWD_RTOL, FWD_BWD_BAL4, FWD_BWD_ROT8,
        all_materials_scene, box_motion_scene, checked_launches, compare_k7,
        cornell_scene_and_settings, fwd_bwd_pixels, k7_inputs,
        many_media_settings, many_media_world, mesh_all_kinds_scene,
        per_lane_backward, plain_backward, reduced_args,
    )
    counters = (bounce_megakernel, bounce_bwd_megakernel_reduced,
                iter_megakernel, bounce_bwd_regen_pre_reduced,
                bounce_bwd_megakernel, bounce_bwd_regen_pre_megakernel)

    cornell, s_c = cornell_scene_and_settings(600, 200, 50, device=dev)
    n_pix = s_c.image_width * s_c.image_height
    s_fb = s_c.replace(rr_depth=FWD_BWD_ROT8["rr_depth"])
    key = rng.base_key(0, dev)
    params, statics = partition(cornell)

    # 29. K7 vs plain on 2^18 lanes of real mid-render states
    n_bwd = FWD_BWD_ROT8["lanes"]
    allm = all_materials_scene(device=dev)
    s_a6 = rt.CameraSettings(background=rt.const_background([0.5, 0.6, 0.7]),
                             image_width=600)
    box, s_box = box_motion_scene(device=dev)
    s_box = s_box.replace(image_width=600)
    mesh, s_mesh = mesh_all_kinds_scene(10, False, 600, device=dev)
    err_k7 = 0.0
    k7_args = None
    for name, sc, s, pixels in (
            ("cornell fwd+bwd", cornell, s_fb, fwd_bwd_pixels(n_pix, n_bwd)),
            ("all-materials", allm, s_a6, None),
            ("all-materials 2 targets", allm,
             s_a6.with_redirect_targets(ALL_MATERIAL_TARGETS), None),
            ("box/motion", box, s_box, None),
            ("box/motion 2 targets", box,
             s_box.with_redirect_targets(ALL_MATERIAL_TARGETS), None),
            ("mixed-kind mesh", mesh, s_mesh, None)):
        args, kw = k7_inputs(sc, s, n_bwd, 4, seed=31,
                             spp=FWD_BWD_ROT8["spp"], pixels=pixels)
        (err, excess), _ = compare_k7(args, kw)
        torch.cuda.synchronize()
        print(f"[K7 vs plain] {name}: {n_bwd} lanes x {kw['n_row'] + 18} "
              f"outputs, {int((args[5] > 0.5).sum())} alive, max |err| "
              f"{err:.3g}, worst excess {excess:.3g} (rtol {BWD_RTOL} of "
              "|plain| + output max + lane max)", flush=True)
        if not excess <= 0.0:
            raise AssertionError(f"K7 vs plain: {name}: out of tolerance")
        tables = row_tables(sc, kw["n_row"])
        err_k7 = max(err_k7, err, _check_reduced(
            f"K7 reduced vs plain: {name}", args, kw, tables))
        if k7_args is None:
            k7_args, k7_kw, k7_tables = args, kw, tables
    phase_done("K7 vs plain")

    # 30./31. routes 8 and 9 at full width, after one warm-up each
    pix = fwd_bwd_pixels(n_pix, n_bwd).to(dev)
    target = torch.zeros((n_bwd, 3), device=dev)

    def runner(cfg, remat=False):
        def run():
            cost = (lane_cost_estimate(cornell, s_fb, key, pix,
                                       spp_est=cfg["spp_est"])
                    if "spp_est" in cfg else None)
            return loss_and_grads(
                params, statics, s_fb, key, pix, target, spp=cfg["spp"],
                n_iters=cfg["n_iters"], remat=remat,
                rotate_k=cfg["rotate_k"], pixel_cost=cost)
        return run

    def route(cfg, remat=False):
        run = runner(cfg, remat)
        run()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        (loss, frac), grads = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        la, l7, lb, l5, l7_lane, l5_lane = (c.launches for c in counters)
        gnp = grads_to_numpy(grads)
        res = dict(seconds=wall, rays_per_s=n_bwd * cfg["spp"] / wall,
                   loss=float(loss), samples_completed=float(frac),
                   launches_a=la, launches_k7=l7,
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   finite=all(bool(np.isfinite(v).all())
                              for v in gnp.values()))
        if (not res["finite"] or l7 == 0 or la == 0 or lb or l5 or l7_lane
                or l5_lane):
            raise AssertionError(f"unfused fwd+bwd {cfg}: bad gradients or "
                                 f"launches A={la} K7 reduced={l7} B={lb} "
                                 f"K5={l5} per lane K7={l7_lane} "
                                 f"K5={l5_lane}")
        return res

    def say(label, cfg, r, cost_iters=0):
        n_it = cfg["n_iters"]
        note = ("kernel A and K7 each equal the iteration count"
                if r["launches_a"] - cost_iters == r["launches_k7"] == n_it
                else f"NOT both equal to the {n_it} iterations")
        print(f"[{label}] cornell 600x600 depth 50 rr2, {n_bwd} lanes x "
              f"{cfg['spp']} spp, rotate_k {cfg['rotate_k']}, {n_it} "
              f"iterations: {r['seconds']:.3f} s, "
              f"{r['rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
              f"{r['loss']:.6f}, samples_completed "
              f"{r['samples_completed']:.6f}, launches A={r['launches_a']} "
              f"K7 reduced={r['launches_k7']} ({note}; "
              f"{_row_mode_name(cornell)}; K7 per lane 0), peak memory "
              f"{r['peak_bytes'] / 2**30:.3f} GiB [{smi}]", flush=True)

    r8 = route(FWD_BWD_ROT8)
    say("route 8", FWD_BWD_ROT8, r8)
    phase_done("route 8")
    # route 9 runs lane_cost_estimate (kernel A, forward only) inside the
    # timed region: its launches are counted apart
    bounce_megakernel.launches = 0
    with torch.no_grad():
        lane_cost_estimate(cornell, s_fb, key, pix,
                           spp_est=FWD_BWD_BAL4["spp_est"])
    cost_iters = bounce_megakernel.launches
    r9 = route(FWD_BWD_BAL4)
    r9["cost_iterations"] = cost_iters
    say(f"route 9 ({cost_iters} of the kernel A launches are the cost "
        "estimate's)", FWD_BWD_BAL4, r9, cost_iters)
    r8m = route(FWD_BWD_ROT8, remat=True)
    print(f"[route 8 remat] peak memory {r8m['peak_bytes'] / 2**30:.3f} GiB "
          f"with remat=True against {r8['peak_bytes'] / 2**30:.3f} GiB "
          f"without; {r8m['seconds']:.3f} s, loss {r8m['loss']:.6f} (without"
          f" {r8['loss']:.6f}), launches A={r8m['launches_a']} (each "
          f"iteration's forward runs again in the backward) "
          f"K7={r8m['launches_k7']} [{smi}]", flush=True)
    if r8m["loss"] != r8["loss"]:
        raise AssertionError("route 8: remat changed the loss")
    phase_done("routes 9 and 8 remat")

    # route 8 with the backward before the reduction moved into K7 and with
    # the reduced K7, in turns
    turns = _in_turns("route 8", runner(FWD_BWD_ROT8),
                      FWD_BWD_ROT8["n_iters"], smi)
    phase_done("route 8 in turns")

    # 32. at 2^14 lanes: K7 against its plain version, the unfused route
    # against the fused one, a finite difference
    n9 = 1 << 14
    pix9 = (torch.arange(n9) * (n_pix // n9)).to(dev, torch.int32)
    tgt9 = torch.zeros((n9, 3), device=dev)
    kw9 = dict(spp=8, n_iters=40, remat=False, rotate_k=2)
    k0 = bounce_bwd_megakernel_reduced.launches
    (l_k, f_k), g_k = loss_and_grads(params, statics, s_fb, key, pix9, tgt9,
                                     **kw9)
    with plain_backward():
        (l_p, f_p), g_p = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, **kw9)
    g_k, g_p = grads_to_numpy(g_k), grads_to_numpy(g_p)
    worst = max(float(np.abs(g_k[k] - g_p[k]).max())
                / max(float(np.abs(g_p[k]).max()), 1e-30) for k in g_p)
    print(f"[unfused fwd+bwd K7 vs plain] {n9} lanes, 8 spp, 40 iterations, "
          f"rotate_k 2: loss {float(l_k):.6f} vs {float(l_p):.6f}, samples "
          f"{float(f_k):.4f}, "
          f"{bounce_bwd_megakernel_reduced.launches - k0} K7 launches, worst "
          f"leaf max|diff|/max|plain| {worst:.3g} (bound {GRAD_RTOL})",
          flush=True)
    if float(l_k) != float(l_p) or float(f_k) != float(f_p) \
            or not worst <= GRAD_RTOL \
            or bounce_bwd_megakernel_reduced.launches - k0 != kw9["n_iters"]:
        raise AssertionError("unfused fwd+bwd: K7 and its plain version "
                             "disagree")
    # rotate_k 2 against the fused rotate_k 1 where every sample completes
    kw_c = dict(spp=8, n_iters=200, remat=False)
    runs = {}
    for rk in (1, 2):
        (loss, frac), g = loss_and_grads(params, statics, s_fb, key, pix9,
                                         tgt9, rotate_k=rk, **kw_c)
        with torch.no_grad():
            img, _ = trace_wavefront_diff(cornell, s_fb, key, pix9,
                                          rotate_k=rk, **kw_c)
        runs[rk] = (float(loss), float(frac), grads_to_numpy(g), img)
    (l1, f1, g1, img1), (l2, f2, g2, img2) = runs[1], runs[2]
    worst = max(float(np.abs(g2[k] - g1[k]).max())
                / max(float(np.abs(g1[k]).max()), 1e-30) for k in g1)
    n_diff = int(((img1 - img2).abs().amax(1) > 1e-5).sum())
    rel = abs(l2 / l1 - 1.0)
    print(f"[unfused vs fused] {n9} lanes, 8 spp, 200 iterations: "
          f"samples {f1:.6f} (fused) {f2:.6f} (rotate_k 2), loss rel diff "
          f"{rel:.3g} (bound 1e-4), worst leaf max|diff|/max|fused| "
          f"{worst:.3g} (bound {GRAD_RTOL}); {n_diff} of {n9} lanes resolve "
          "differently (kernels A and B may round the camera differently)",
          flush=True)
    if f1 != 1.0 or f2 != 1.0 or not rel <= 1e-4 or not worst <= GRAD_RTOL:
        raise AssertionError("the unfused and the fused routes disagree")
    # a central finite difference of the red wall's albedo, unfused
    s_fd = s_c.replace(rr_depth=None)
    tgt_fd = torch.full((n9, 3), 0.1, device=dev)
    kw_fd = dict(spp=8, n_iters=80, remat=False, rotate_k=2)
    _, g_fd = loss_and_grads(params, statics, s_fd, key, pix9, tgt_fd,
                             **kw_fd)
    tex = cornell.textures
    red = int(torch.argmax(tex.c0[:, 0] - tex.c0[:, 1]))

    def loss_at(x):
        c0 = tex.c0.clone()
        c0[red, 0] = x[0]
        sc = dataclasses.replace(cornell,
                                 textures=dataclasses.replace(tex, c0=c0))
        with torch.no_grad():
            return render_loss_wavefront(*partition(sc), s_fd, key, pix9,
                                         tgt_fd, **kw_fd)[0]
    fd = float(finite_difference(loss_at, tex.c0[red, 0:1].clone(), 1e-2)[0])
    gv = float(g_fd.textures.c0[red, 0])
    print(f"[finite difference, unfused] red wall albedo (texture {red}, red "
          f"channel), rotate_k 2: gradient {gv:.6g}, central difference "
          f"{fd:.6g} (eps 0.01), rel diff {abs(gv - fd) / abs(fd):.3g} "
          f"(bound {FD_RTOL})", flush=True)
    if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
        raise AssertionError("finite difference through the unfused route")
    phase_done("unfused checks at 2^14 lanes")

    # 33. 17 media (F8): renders with every crossing launch checked, of
    # fog balls and boxes (K11) and of rotated boxes (102 rows: K11b)
    k8_l = k11_l = k11b_l = shade_l = 0
    for rotated in (False, True):
        many = rt.compile_scene(many_media_world(rt, 17, rotated), device=dev)
        kname = ("pallas_volume_candidates_bcast" if rotated
                 else "pallas_volume_candidates")
        with checked_launches() as stats:
            acc, total = render_accumulate(many, many_media_settings(
                rt, 400, 4, 10), seed=0, spp=4)
        st_v, st8 = stats[kname], stats["pallas_nearest_record"]
        finite = bool(torch.isfinite(acc).all())
        print(f"[17 media] {many.volumes.n_volumes} media "
              f"({many.volumes.prims.kind.shape[0]} boundary rows) 400x400 "
              f"4 spp depth 10: {st_v['launches']} launches of {kname} (two "
              f"a bounce: 16 + 1 media) over {st8['launches']} iterations, "
              f"in the candidate mode, every one against its plain "
              f"version: material id or scattering differ on "
              f"{st_v['n_int']} lanes, t_med max |err| {st_v['err']:.3g} "
              f"(worst ulps over CAND_ULPS {st_v['excess']:.3g}); mean "
              f"{float((acc / total).mean()):.6f}, finite {finite}",
              flush=True)
        if (not finite or st_v["launches"] != 2 * st8["launches"]
                or st_v["n_int"] or st_v["excess"] > 0
                or st8["launches"] == 0):
            raise AssertionError("17 media: candidate launches disagree")
        k8_l += st8["launches"]
        shade_l += stats["shade_megakernel"]["launches"]
        if rotated:
            k11b_l += st_v["launches"]
        else:
            k11_l += st_v["launches"]
    phase_done("17 media")

    # 34. K7's time at 2^18 lanes (the Cornell state of phase 29), as
    # K5's in phase 12
    k7_red = lambda: bounce_bwd_megakernel_reduced(
        *reduced_args(k7_args, k7_tables), **k7_kw)
    ms_k7 = _device_ms(k7_red, ("bounce_bwd_replay_kernel", "row_sum_kernel",
                                "row_map_kernel"), 50)
    ms_k7_main = _device_ms(k7_red, "bounce_bwd_replay_kernel", 50)
    host_k7 = _time_ms(k7_red, 50)
    k7_lane = lambda: bounce_bwd_megakernel(*k7_args, **k7_kw)
    ms_k7_lane = _device_ms(k7_lane, "bounce_bwd_replay_kernel", 50)
    host_k7_lane = _time_ms(k7_lane, 50)
    with per_lane_backward():
        from raytrace_tpu_torch.ops import bounce_bwd_kernel as k7_mod
        old_k7 = k7_mod.bounce_bwd_megakernel_reduced
        old_call = lambda: old_k7(*reduced_args(k7_args, k7_tables),
                                  **k7_kw)
        total_old = _device_total_ms(old_call, 10)
        host_old = _time_ms(old_call, 10)
    plain_k7 = _time_ms(lambda: bounce_bwd_megakernel_reduced_plain(
        *reduced_args(k7_args, k7_tables), **k7_kw), 3, 1)
    bound_k7 = _bwd_bound(n_bwd, 32, 11, k7_tables, k7_kw["n_row"])
    print(f"[time] K7 reduced {ms_k7:.4f} ms on the device ({ms_k7_main:.4f}"
          f" ms the kernel, the rest the finishing launches; {host_k7:.4f} ms"
          f" a call back to back) vs its "
          f"plain version {plain_k7:.3f} ms at {n_bwd} lanes, bound "
          f"{bound_k7[0]:.4f} ms ({bound_k7[1]}: 32 columns in, 11 out, the "
          f"table and the reduced tables); before: the per-lane mode "
          f"{ms_k7_lane:.4f} ms on the device ({host_k7_lane:.4f} ms a call), "
          f"with the torch gather and index_add_ around it {total_old:.4f} ms "
          f"of device time a call ({host_old:.4f} ms a call back to back) "
          f"[{smi}]", flush=True)
    phase_done("K7 time")

    summary = dict(route8=r8, route9=r9, route8_remat=r8m,
                   unfused_vs_fused_lanes_differing=n_diff)
    kernel = {"name": "bounce_bwd_megakernel_reduced", "route": "cuda",
              "source": "raytrace_tpu_torch/csrc/bounce_bwd_kernel.cu",
              "replaces": "raytrace_tpu/ops/pallas/bounce_bwd_kernel.py:79",
              "launches": r8["launches_k7"] + r9["launches_k7"],
              "max_abs_err": err_k7, "ms": ms_k7, "host_ms": host_k7,
              "plain_ms": plain_k7, "bound_ms": bound_k7[0],
              "bound_by": bound_k7[1], "library_ms": None,
              "kernel_ms": ms_k7_main, "per_lane_ms": ms_k7_lane,
              "per_lane_host_ms": host_k7_lane,
              "per_lane_with_torch_reduction_ms": total_old,
              "per_lane_with_torch_reduction_host_ms": host_old}
    return dict(summary=summary, kernel=kernel, turns=turns,
                a_launches=r8["launches_a"] + r9["launches_a"],
                k8_launches=k8_l, k11_launches=k11_l, k11b_launches=k11b_l,
                shade_launches=shade_l)


def _named_grads(loss, params) -> dict:
    """``{leaf path: gradient}`` of ``loss`` for every float leaf of the
    scene ``params`` (zeros where it does not reach)."""
    import torch
    from raytrace_tpu_torch.diff.gradients import leaves
    named = {k: v for k, v in leaves(params).items() if v.requires_grad}
    gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return {k: (torch.zeros_like(v) if g is None else g)
            for (k, v), g in zip(named.items(), gs)}


def _grads_close(a: dict, b: dict) -> float:
    """The worst ``|a - b| / |a|`` (L2, per leaf) over the leaves of
    ``a`` whose norm is above 0; raises if a leaf zero in ``a`` is not in
    ``b``."""
    worst = 0.0
    for k, x in a.items():
        nx = float(x.norm())
        d = float((x - b[k]).norm())
        if nx == 0.0:
            if d != 0.0:
                raise AssertionError(f"{k}: zero against {d}")
            continue
        worst = max(worst, d / nx)
    return worst


def _generic_phases(smi, phase_done, dev) -> dict:
    """Phases 35-40 (the generic bounce, the media's gradients and the
    bounded-depth path) on ``dev``.  Returns the summary for the JSON
    line, the launches of K8, K9, K12 and the keyed K11 and K11b on these
    routes, and the keyed mode's entries of the K11 and K11b rows."""
    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        combine, grad_render, leaves, loss_and_grads, partition,
        render_tile,
    )
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.texture_kernel import marble_stripe_pallas
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
        volume_crossings_plain,
    )
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.integrator import trace_wavefront_diff
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.render.volumes import (
        crossing_kw, volume_crossings, volume_crossings_keyed, volume_tables,
    )
    from raytrace_tpu_torch.testing import (
        PAWN_FWD_BWD, SMOKE_FWD_BWD, SMOKE_GRAD_RENDER, camera_rays,
        checked_launches, compare_keyed, cornell_scene_and_settings,
        cornell_smoke_scene, fog_settings, fog_world, fwd_bwd_pixels,
        general_tables, marble_light_scene, nine_target_scene,
        pawn_inside_rays, pawn_standin_scene, plain_kernels,
        stationary_lanes, volume_rays, volume_test_world,
    )
    k11, k11b = pallas_volume_crossings, pallas_volume_crossings_bcast
    counters = (bounce_megakernel, iter_megakernel, pallas_nearest_record,
                allpairs_nearest_record, shade_megakernel, k11, k11b,
                marble_stripe_pallas)

    def reset():
        for c in counters:
            c.launches = 0
        for c in (k11, k11b):
            c.keyed_launches = c.candidate_launches = 0

    def read():
        got = {c.__name__: c.launches for c in counters}
        got["K11 keyed"] = k11.keyed_launches
        got["K11b keyed"] = k11b.keyed_launches
        return got

    # 35. the keyed mode of K11 (planar and general) and K11b against its
    # plain version, and against the crossings mode's values
    def check_keyed(label, volumes, comps, tables):
        (n_int, err, excess), n_mode = compare_keyed(volumes, comps,
                                                     tables=tables)
        print(f"[{label}] {comps.shape[1]} rays: flags or keys differ on "
              f"{n_int} lanes, crossings max |err| {err:.3g}, {n_mode} "
              f"lanes' crossings differ from the crossings mode's", flush=True)
        if n_int or err or n_mode:
            raise AssertionError(f"{label}: keyed mode disagrees")
        return err

    sz = GENERIC
    smoke, s_s = cornell_smoke_scene(sz["width"], SMOKE_FWD_BWD["spp"], 50,
                                     device=dev)
    pawn, s_p = pawn_standin_scene(sz["pawn_width"], PAWN_FWD_BWD["spp"], 20,
                                   device=dev)
    tables_s = volume_tables(smoke.volumes)
    general_s = general_tables(tables_s)
    n_pix_s, lanes_s, lane_pix_s = stationary_lanes(s_s)
    cam_s, _ = camera_rays(smoke, s_s, lanes_s, 101,
                           pixels=torch.from_numpy(lane_pix_s))
    err_k = err_kb = 0.0
    for label, tb in (("planar", tables_s), ("general", general_s)):
        err_k += check_keyed(f"K11 keyed, {label}, vs plain: cornell_smoke "
                             "600x600 camera rays", smoke.volumes, cam_s, tb)
    for moving in (False, True):
        world = rt.compile_scene(volume_test_world(rt, moving), device=dev)
        comps = volume_rays(sz["fog_rays"], 84 + moving, (-6.0, 6.0),
                            ([0.0, 0.0, -3.0], [3.2, 0.0, -3.5]), device=dev)
        err_k += check_keyed(
            f"K11 keyed, general, vs plain: fog ball and smoke box"
            f"{' moving' if moving else ''}, random rays", world.volumes,
            comps, volume_tables(world.volumes))
    n_k = sz["pawn_rays"]
    n_pix_p = s_p.image_width * s_p.image_height
    pix_p = (torch.arange(n_k) * n_pix_p // n_k).to(torch.int32)
    cam_p, _ = camera_rays(pawn, s_p, n_k, 102, pixels=pix_p)
    tables_p = volume_tables(pawn.volumes)
    for label, comps in (("camera rays", cam_p),
                         ("rays from inside the medium",
                          pawn_inside_rays(n_k, 103, device=dev))):
        err_kb += check_keyed(f"K11b keyed vs plain: pawn stand-in 500x500 "
                              f"{label}", pawn.volumes, comps, tables_p)
    phase_done("keyed crossings vs plain")

    # the keyed mode's times beside the crossings mode's, in turns, and
    # their bounds: 28 bytes of rays read, 20 a medium written (12 of
    # crossings, 8 of keys), the table read; K11 the SASS instructions of
    # its keyed planar row loop a ray and row, K11b the walk's box tests
    # and row tests (the crossings mode's: the same walk)
    rays_s = tuple(cam_s.unbind(0))
    rays_p = tuple(cam_p.unbind(0))
    nv_s = smoke.volumes.n_volumes
    turns = {"K11": {"keyed": [], "crossings": []},
             "K11b": {"keyed": [], "crossings": []}}
    calls = {("K11", "keyed"): lambda: volume_crossings_keyed(
                 smoke.volumes, rays_s, s_s.t_min, tables_s),
             ("K11", "crossings"): lambda: volume_crossings(
                 smoke.volumes, rays_s, s_s.t_min, tables_s),
             ("K11b", "keyed"): lambda: volume_crossings_keyed(
                 pawn.volumes, rays_p, s_p.t_min, tables_p),
             ("K11b", "crossings"): lambda: volume_crossings(
                 pawn.volumes, rays_p, s_p.t_min, tables_p)}
    names = {"K11": "volume_crossings_kernel", "K11b": "volume_bvh_kernel"}
    for mode in ("crossings", "keyed", "keyed", "crossings"):
        for k in ("K11", "K11b"):
            fn = calls[(k, mode)]
            turns[k][mode].append((_device_ms(fn, names[k], 50),
                                   _time_ms(fn, 50)))
    kw_s = crossing_kw(smoke.volumes, s_s.t_min)
    kw_p = crossing_kw(pawn.volumes, s_p.t_min)
    plain_k = _time_ms(lambda: volume_crossings_plain(
        tables_s.vtbl, *rays_s, keys=True, **kw_s), 5, 1)
    plain_kb = _time_ms(lambda: volume_crossings_plain(
        tables_p.vtbl, *rays_p, keys=True, **kw_p), 2, 1)
    row_ins = None
    per_k = source_constant("volume_kernel", "kRays")
    for name, count in inner_loop_sizes("volume_kernel",
                                        "volume_crossings_kernel"):
        flags = re.search(r"volume_crossings_kernelILb(\d)ELb(\d)ELb(\d)E"
                          r"Lb(\d)ELb(\d)E", name)
        if flags and tuple(int(x) for x in flags.groups()) == (1, 0, 0, 0,
                                                               1):
            row_ins = count / per_k
    if row_ins is None:
        raise AssertionError("K11's keyed planar row loop not in its SASS")
    rows_s = tables_s.vtbl.shape[0]
    bound_k = _bound_ms(lanes_s * (28 + 20 * nv_s)
                        + 4 * tables_s.vtbl.numel(),
                        lanes_s * rows_s * row_ins)
    _, visits = pallas_volume_crossings_bcast(
        tables_p.vtbl, tables_p.forest, *rays_p, count_visits=True, **kw_p)
    v = visits.double()
    forest = tables_p.forest
    bound_kb = _bound_ms(n_k * (28 + 20) + 4 * (forest.nodes.numel()
                                                + forest.rows.numel()),
                         float(v[0].sum()) * VOL_BOX_OPS
                         + float(v[1].sum()) * VOL_ROW_OPS)
    best = {k: {m: (min(x[0] for x in t), min(x[1] for x in t))
                for m, t in d.items()} for k, d in turns.items()}
    for k, n, plain, bound, what in (
            ("K11", lanes_s, plain_k, bound_k,
             f"cornell_smoke camera rays, planar, {row_ins:.1f} "
             "instructions a ray and row"),
            ("K11b", n_k, plain_kb, bound_kb,
             f"pawn stand-in camera rays, {float(v[0].mean()):.2f} box and "
             f"{float(v[1].mean()):.2f} row tests a ray")):
        print(f"[time] {k} keyed mode at {n} {what}: "
              f"{best[k]['keyed'][0]:.4f} ms on the device "
              f"({best[k]['keyed'][1]:.4f} ms a call back to back), the "
              f"crossings mode {best[k]['crossings'][0]:.4f} "
              f"({best[k]['crossings'][1]:.4f}), in turns (crossings, keyed, "
              f"keyed, crossings: {turns[k]}), vs the keyed plain version "
              f"{plain:.3f} ms; bound {bound[0]:.5f} ms ({bound[1]}) [{smi}]",
              flush=True)
    phase_done("keyed crossing times")

    def fwd_bwd_run(scene, settings, cfg, lanes, spp, n_iters, schedule):
        params, statics = partition(scene)
        n_pix = settings.image_width * settings.image_height
        pix = fwd_bwd_pixels(n_pix, lanes).to(dev)
        target = torch.zeros((lanes, 3), device=dev)
        s_cfg = settings.replace(rr_depth=cfg["rr_depth"])
        return lambda: loss_and_grads(
            params, statics, s_cfg, rng.base_key(0, dev), pix, target,
            spp=spp, n_iters=n_iters, remat=cfg["remat"], schedule=schedule)

    def timed(run, prof_run, label, lanes, spp, n_iters, prof_iters):
        """One timed call of ``run`` (after the checked runs, which warm the
        process up) and one profiled call of ``prof_run`` (the same lanes,
        ``prof_iters`` iterations: a profile of the whole run records
        hundreds of thousands of events and takes minutes)."""
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (loss, frac), grads = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            prof_run()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t1
        ops = _device_ops(prof)
        n_ops = sum(c for c, _ in ops.values())
        dev_ms = sum(us for _, us in ops.values()) / 1e3
        top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:6]
        gl = leaves(grads)
        finite = all(bool(torch.isfinite(g).all()) for g in gl.values()
                     if g is not None and g.is_floating_point())
        res = dict(wall_s=wall, loss=float(loss), samples_completed=float(frac),
                   primary_rays_per_s=lanes * spp * float(frac) / wall,
                   device_ms_per_iter=dev_ms / prof_iters,
                   busy_share=dev_ms / 1e3 / prof_wall,
                   device_ops_per_iter=n_ops / prof_iters,
                   peak_bytes=peak, launches=launches, finite=finite,
                   top_ops=[(k[:60], c, us / 1e3) for k, (c, us) in top])
        print(f"[{label}] wall {wall:.3f} s ({n_iters} iterations), "
              f"{res['primary_rays_per_s'] / 1e6:.3f} M primary rays/s, loss "
              f"{res['loss']:.6f}, samples completed "
              f"{res['samples_completed']:.6f}, peak {peak / 2**30:.3f} GiB, "
              f"launches {launches}, gradients finite {finite}; profiled "
              f"{prof_iters} iterations: {res['device_ms_per_iter']:.3f} ms "
              f"of device time and {res['device_ops_per_iter']:.1f} device "
              f"ops an iteration, {res['busy_share']:.3f} of the profiled "
              f"wall busy; top device ops {res['top_ops']} [{smi}]",
              flush=True)
        return res, grads

    # 36. the media fwd+bwd at full size, through the generic
    # differentiable bounce: first at 2^14 lanes x 4 spp every K8 and
    # keyed K11 launch against its plain version, and the run against the
    # one with every plain version (these warm the process up)
    cfg = SMOKE_FWD_BWD
    sched = cfg["schedule"]
    small = fwd_bwd_run(smoke, s_s, cfg, sz["checked_lanes"], 4, 30, None)
    with checked_launches() as st:
        (l_k, f_k), g_k = small()
    torch.cuda.synchronize()
    with plain_kernels():
        (l_p, f_p), g_p = small()
    for name in ("pallas_nearest_record", "pallas_volume_crossings_keyed"):
        x = st[name]
        print(f"[36 checked] {name}: {x['launches']} launches, exact rows "
              f"differ on {x['n_int']} lanes, max |err| {x['err']:.3g}",
              flush=True)
        if x["launches"] == 0 or x["n_int"] or x["err"]:
            raise AssertionError(f"{name}: disagrees with its plain version")
    lk, lp = leaves(g_k), leaves(g_p)
    worst = _grads_close({k: v for k, v in lp.items() if v is not None
                          and v.is_floating_point()}, lk)
    rel = abs(float(l_k) - float(l_p)) / abs(float(l_p))
    print(f"[36 vs plain] {sz['checked_lanes']} lanes x 4 spp: loss "
          f"{float(l_k):.7f} vs {float(l_p):.7f} (rel {rel:.3g}), completed "
          f"{float(f_k):.4f}; gradients' worst L2 |kernels - plain| / |plain| "
          f"{worst:.3g} (tolerance {GRAD_RTOL}: the backward's index adds "
          f"are atomics)", flush=True)
    if rel > 1e-6 or worst > GRAD_RTOL:
        raise AssertionError("media fwd+bwd: kernels against plain")
    n_it36 = cfg["n_iters"] + sum(i for i, _ in sched)
    run36 = fwd_bwd_run(smoke, s_s, cfg, cfg["lanes"], cfg["spp"],
                        cfg["n_iters"], sched)
    prof36 = fwd_bwd_run(smoke, s_s, cfg, cfg["lanes"], cfg["spp"], 10, None)
    r36, g36 = timed(run36, prof36, "media fwd+bwd: cornell_smoke 600x600, "
                     f"depth 50, {cfg['lanes']} lanes x {cfg['spp']} spp, "
                     "remat", cfg["lanes"], cfg["spp"], n_it36, 10)
    dens = g36.volumes.density
    others = (r36["launches"]["bounce_megakernel"]
              + r36["launches"]["iter_megakernel"]
              + r36["launches"]["shade_megakernel"])
    if (not r36["finite"] or r36["samples_completed"] < 0.999
            or not bool((dens != 0).any())
            or r36["launches"]["pallas_nearest_record"] == 0
            or r36["launches"]["K11 keyed"] == 0 or others):
        raise AssertionError("media fwd+bwd: incomplete, not finite, no "
                             "density gradient, or a kernel missing")
    print(f"[media fwd+bwd] d loss / d density {dens.tolist()}", flush=True)
    phase_done("media fwd+bwd")

    # 37. the mesh-boundary media fwd+bwd: K9 and the keyed K11b
    cfg_p = PAWN_FWD_BWD
    with checked_launches() as st:
        fwd_bwd_run(pawn, s_p, cfg_p, sz["pawn_checked_lanes"], 2, 20,
                    None)()
    for name in ("allpairs_nearest_record",
                 "pallas_volume_crossings_bcast_keyed"):
        x = st[name]
        print(f"[37 checked] {name}: {x['launches']} launches, exact rows "
              f"differ on {x['n_int']} lanes, max |err| {x['err']:.3g}",
              flush=True)
        if x["launches"] == 0 or x["n_int"] or x["err"]:
            raise AssertionError(f"{name}: disagrees with its plain version")
    run37 = fwd_bwd_run(pawn, s_p, cfg_p, cfg_p["lanes"], cfg_p["spp"],
                        cfg_p["n_iters"], None)
    prof37 = fwd_bwd_run(pawn, s_p, cfg_p, cfg_p["lanes"], cfg_p["spp"], 10,
                         None)
    r37, _ = timed(run37, prof37, f"pawn fwd+bwd: 500x500, depth 20, "
                   f"{cfg_p['lanes']} lanes x {cfg_p['spp']} spp, remat",
                   cfg_p["lanes"], cfg_p["spp"], cfg_p["n_iters"], 10)
    if (not r37["finite"] or r37["launches"]["allpairs_nearest_record"] == 0
            or r37["launches"]["K11b keyed"] == 0):
        raise AssertionError("pawn fwd+bwd: not finite or a kernel missing")
    phase_done("pawn fwd+bwd")

    # 38. the generic route on the Cornell box (use_mega=False) against
    # the fused route: the same estimator and draws
    cornell, s_c = cornell_scene_and_settings(sz["width"], 8, 50, device=dev)
    s_c = s_c.replace(rr_depth=2)
    lanes38 = sz["cornell_lanes"]
    pix38 = fwd_bwd_pixels(sz["width"] ** 2, lanes38).to(dev)
    out38 = {}
    for route, kw in (("fused", {}), ("generic", dict(use_mega=False))):
        params, statics = partition(cornell)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, done = trace_wavefront_diff(combine(params, statics), s_c,
                                         rng.base_key(0, dev), pix38, 8,
                                         n_iters=sz["cornell_iters"],
                                         remat=True, **kw)
        loss = torch.mean(img ** 2)
        g = _named_grads(loss, params)
        torch.cuda.synchronize()
        out38[route] = (float(loss.detach()), float(torch.mean(done / 8.0)), g,
                        time.perf_counter() - t0, read())
    (lf, ff, gf, wf, cf), (lg, fg, gg, wg, cg) = (out38["fused"],
                                                  out38["generic"])
    worst38 = _grads_close(gf, gg)
    rel38 = abs(lg - lf) / abs(lf)
    print(f"[38 generic vs fused] Cornell {sz['width']} px, {lanes38} lanes "
          f"x 8 spp, {sz['cornell_iters']} iterations: loss {lg:.7f} vs {lf:.7f} (rel {rel38:.3g}, "
          f"tolerance 1e-3), completed {fg:.5f} vs {ff:.5f}, gradients' "
          f"worst L2 |generic - fused| / |fused| {worst38:.3g} (tolerance "
          f"0.05); walls {wg:.3f} vs {wf:.3f} s; generic launches {cg}",
          flush=True)
    if (rel38 > 1e-3 or worst38 > 0.05 or cg["pallas_nearest_record"] == 0
            or cg["iter_megakernel"] or cg["bounce_megakernel"]):
        raise AssertionError("generic route: disagrees with the fused one")
    phase_done("generic vs fused")

    # 39. the generic forward: a marble-lit scene (K8 and K12) and a scene
    # of nine redirect targets (K8 and K11's candidate mode)
    r39 = {}
    w39, spp = sz["forward_width"], sz["forward_spp"]
    for label, (scene, settings) in (
            ("marble_light", marble_light_scene(w39, spp, 50, device=dev)),
            ("nine_targets", nine_target_scene(w39, spp, 50, device=dev))):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, total = render_accumulate(scene, settings, seed=0, spp=spp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        img = acc / total
        write_image(os.path.join(OUT_DIR, f"{label}.png"),
                    img.reshape(settings.image_height, settings.image_width,
                                3).cpu().numpy())
        small = settings.replace(image_width=sz["checked_width"])
        with checked_launches() as st:
            render_accumulate(scene, small, seed=1, spp=2)
        checked = {k: v for k, v in st.items() if v["launches"]}
        r39[label] = dict(wall_s=wall, launches=got,
                          mean=float(img.mean()), checked=checked)
        print(f"[39 generic forward] {label} {w39} px, {spp} spp, depth 50: "
              f"wall {wall:.3f} s, mean {float(img.mean()):.5f}, launches "
              f"{got}; checked {sz['checked_width']} px x 2 spp: {checked} "
              f"[{smi}]", flush=True)
        if (not bool(torch.isfinite(img).all())
                or got["pallas_nearest_record"] == 0
                or got["bounce_megakernel"] or got["shade_megakernel"]
                or any(v["n_int"] or v["err"] for v in checked.values())):
            raise AssertionError(f"{label}: generic forward")
    if (r39["marble_light"]["launches"]["marble_stripe_pallas"] == 0
            or "marble_stripe_pallas" not in r39["marble_light"]["checked"]
            or r39["nine_targets"]["launches"]["pallas_volume_crossings"]
            == 0):
        raise AssertionError("generic forward: K12 or K11 not launched")
    phase_done("generic forward")

    # 40. grad_render on cornell_smoke, and the fog density check
    n_t, n_s = SMOKE_GRAD_RENDER["pixels"], SMOKE_GRAD_RENDER["samples"]
    pix40 = torch.arange(n_t, dtype=torch.int32, device=dev)
    smp40 = torch.arange(n_s, dtype=torch.int32)
    target40 = torch.zeros((n_t, 3), device=dev)
    grad_render(smoke, s_s, rng.base_key(2, dev), pix40[:1024], smp40,
                target40[:1024])                       # warm-up
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss40, g40 = grad_render(smoke, s_s, rng.base_key(2, dev), pix40, smp40,
                              target40)
    torch.cuda.synchronize()
    wall40 = time.perf_counter() - t0
    peak40 = torch.cuda.max_memory_allocated()
    l40 = read()
    fin40 = all(bool(torch.isfinite(g).all()) for g in leaves(g40).values()
                if g is not None and g.is_floating_point())
    print(f"[40 grad_render] cornell_smoke {sz['width']} px, a tile of {n_t} "
          f"pixels x "
          f"{n_s} samples, depth 50: wall {wall40:.3f} s, loss "
          f"{float(loss40):.6f}, peak {peak40 / 2**30:.3f} GiB, gradients "
          f"finite {fin40}, d loss / d density "
          f"{g40.volumes.density.tolist()}, launches {l40} [{smi}]",
          flush=True)
    if not fin40 or l40["pallas_nearest_record"] == 0 \
            or l40["K11 keyed"] == 0:
        raise AssertionError("grad_render: not finite or a kernel missing")
    fog = rt.compile_scene(fog_world(rt), device=dev)
    s_f = fog_settings(rt)
    params, statics = partition(fog)

    def fog_mean(dens, seed):
        vol = dataclasses.replace(params.volumes, density=dens)
        sc = combine(dataclasses.replace(params, volumes=vol), statics)
        return torch.mean(render_tile(
            sc, s_f, rng.base_key(seed, dev),
            torch.arange(256, dtype=torch.int32, device=dev),
            torch.arange(8, dtype=torch.int32), differentiable=True))

    gs = []
    for seed in range(4):
        d0 = torch.tensor([0.8], device=dev, requires_grad=True)
        gs.append(float(torch.autograd.grad(fog_mean(d0, seed), d0)[0][0]))
    g_ad = float(np.mean(gs))
    with torch.no_grad():
        fd = lambda x: np.mean([float(fog_mean(torch.tensor([x], device=dev),
                                               seed)) for seed in range(4, 10)])
        g_fd = (fd(0.95) - fd(0.65)) / 0.3
    ok = g_ad < -0.05 and g_fd < -0.05 and abs(g_ad - g_fd) <= 0.35 * abs(g_fd)
    print(f"[40 fog density] d(mean radiance)/d(density): score-function "
          f"{g_ad:.5f} (4 seeds: {gs}) vs central difference at +-0.15 "
          f"{g_fd:.5f} (6 seeds); both < -0.05 and within rtol 0.35: {ok}",
          flush=True)
    if not ok:
        raise AssertionError("fog density gradient against FD")
    phase_done("grad_render")

    summary = dict(media_fwd_bwd=r36, pawn_fwd_bwd=r37,
                   generic_vs_fused=dict(loss_rel=rel38, grad_worst=worst38,
                                         walls_s=(wg, wf)),
                   generic_forward=r39,
                   grad_render=dict(wall_s=wall40, peak_bytes=peak40,
                                    loss=float(loss40)),
                   fog_density=dict(ad=g_ad, fd=g_fd))
    keyed = {
        "K11": dict(keyed_ms=best["K11"]["keyed"][0],
                    keyed_host_ms=best["K11"]["keyed"][1],
                    keyed_crossings_mode_ms=best["K11"]["crossings"][0],
                    keyed_plain_ms=plain_k, keyed_bound_ms=bound_k[0],
                    keyed_bound_by=bound_k[1], keyed_max_abs_err=err_k),
        "K11b": dict(keyed_ms=best["K11b"]["keyed"][0],
                     keyed_host_ms=best["K11b"]["keyed"][1],
                     keyed_crossings_mode_ms=best["K11b"]["crossings"][0],
                     keyed_plain_ms=plain_kb, keyed_bound_ms=bound_kb[0],
                     keyed_bound_by=bound_kb[1], keyed_max_abs_err=err_kb)}
    runs = (r36["launches"], r37["launches"], cg, l40,
            r39["marble_light"]["launches"], r39["nine_targets"]["launches"])
    keyed["K11"]["keyed_launches"] = sum(x["K11 keyed"] for x in runs)
    keyed["K11b"]["keyed_launches"] = sum(x["K11b keyed"] for x in runs)
    return dict(summary=summary, keyed=keyed,
                k8_launches=sum(x["pallas_nearest_record"] for x in runs),
                k9_launches=sum(x["allpairs_nearest_record"] for x in runs),
                k12_launches=sum(x["marble_stripe_pallas"] for x in runs),
                k11_launches=sum(x["pallas_volume_crossings"] for x in runs),
                k11b_launches=sum(x["pallas_volume_crossings_bcast"]
                                  for x in runs))


# the sizes of phases 41-45: the K10 lanes' image width; the ellipsoid
# scene's forward (width, spp) and its checked render's width; the
# fwd+bwd tiles (pixels, samples) of the checked runs; the rays of the
# ellipsoid's hit-t difference; demo2's forward spp (the scene renders
# 250; see DEMO2_FWD_SPP) and its profiled spp; the fog-density check's
# tile, samples and seeds
M11 = dict(k10_width=600, ell_width=600, ell_spp=16, ell_checked_width=128,
           checked_pixels=1 << 12, checked_samples=2, hit_t_rays=1 << 14,
           demo2_prof_spp=8, fog_pixels=1 << 14, fog_samples=4,
           fog_ad_seeds=4, fog_fd_seeds=6)
# demo2's forward samples per pixel in the smoke: the scene's own 250
DEMO2_FWD_SPP = 250


def _profiled(fn, counter) -> dict:
    """One call of ``fn`` under torch.profiler: its wall, the device time
    and device ops it ran, the iterations (``counter``'s launches in it),
    and the busy share of its wall."""
    import torch
    torch.cuda.synchronize()
    n0 = counter.launches
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = max(counter.launches - n0, 1)
    ops = _device_ops(prof)
    dev_s = sum(us for _, us in ops.values()) / 1e6
    n_ops = sum(c for c, _ in ops.values())
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:6]
    return dict(profiled_wall_s=wall, iterations=iters,
                device_ms_per_iter=1e3 * dev_s / iters,
                device_ops_per_iter=n_ops / iters, busy_share=dev_s / wall,
                top_ops=[(k[:60], c, us / 1e3) for k, (c, us) in top])


def _m11_phases(smi, phase_done, dev) -> dict:
    """Phases 41-45 (the rest of M11: object-space sphere uv, K10's
    rotation table, ellipsoids, demo2) on ``dev``.  Returns the summary
    for the JSON line, the launches of K8, K9, K10, K11, K12 and K13 on
    these routes, and the ``kernels`` entry of K10's rotation mode."""
    import numpy as np
    import torch
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        combine, grad_render, leaves, partition, render_tile,
    )
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel, shade_plain, sphere_rot_table,
    )
    from raytrace_tpu_torch.ops.image_grad_kernel import image_grad_pallas
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.ops.texture_kernel import marble_stripe_pallas
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
    )
    from raytrace_tpu_torch.render import integrator
    from raytrace_tpu_torch.render.camera import camera_frame
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        BOUNCE_INT_ROWS, DEMO2_GRAD, DEMO2_SEED, camera_rays,
        checked_launches, demo2_scene, ellipsoid_scene, max_errs,
        plain_kernels, rotated_spheres_scene, sphere_rot_inputs,
        synthetic_medium,
    )
    k11, k11b = pallas_volume_crossings, pallas_volume_crossings_bcast
    counters = (bounce_megakernel, iter_megakernel, pallas_nearest_record,
                allpairs_nearest_record, shade_megakernel, k11, k11b,
                marble_stripe_pallas, image_grad_pallas)

    def reset():
        for c in counters:
            c.launches = 0
        for c in (k11, k11b):
            c.keyed_launches = c.candidate_launches = 0
        shade_megakernel.rot_launches = 0

    def read():
        got = {c.__name__: c.launches for c in counters}
        got["K11 keyed"] = k11.keyed_launches
        got["K11 candidate"] = k11.candidate_launches
        got["K11b"] = k11b.launches
        got["K10 sphere_rots"] = shade_megakernel.rot_launches
        return got

    def check_stats(label, st, names):
        """Every launch of ``names`` in the checked run ``st`` exact (the
        atlas gradient within its summation-order bound)."""
        for name in names:
            x = st[name]
            print(f"[{label} checked] {name}: {x['launches']} launches, "
                  f"exact rows differ on {x['n_int']} lanes, max |err| "
                  f"{x['err']:.3g}, worst excess {x['excess']:.3g}",
                  flush=True)
            bad = x["excess"] > 0 if name == "image_grad_pallas" \
                else (x["n_int"] or x["err"])
            if x["launches"] == 0 or bad:
                raise AssertionError(f"{label}: {name} disagrees with its "
                                     "plain version or did not launch")
        return max(st[n]["err"] for n in names)

    def forward_run(label, scene, settings, spp, seed, counter, png):
        """``render_accumulate`` of ``scene`` at ``spp``: wall, primary
        rays/s, launches, peak memory; the image to chiprun_out/``png``."""
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        acc, total = render_accumulate(scene, settings, seed=seed, spp=spp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        peak = torch.cuda.max_memory_allocated()
        img = acc / total
        n_pix = settings.image_width * settings.image_height
        res = dict(wall_s=wall, primary_rays_per_s=n_pix * spp / wall,
                   iterations=counter.launches, launches=got,
                   peak_bytes=peak, mean=float(img.mean()),
                   finite=bool(torch.isfinite(img).all()))
        write_image(os.path.join(OUT_DIR, png),
                    img.reshape(settings.image_height, settings.image_width,
                                3).cpu().numpy())
        print(f"[{label}] {settings.image_width}x{settings.image_height} "
              f"{spp} spp depth {settings.max_depth} seed {seed}: wall "
              f"{wall:.3f} s, {res['primary_rays_per_s'] / 1e6:.3f} M primary "
              f"rays/s, {res['iterations']} iterations, peak "
              f"{peak / 2**30:.3f} GiB, mean {res['mean']:.6f}, finite "
              f"{res['finite']}, launches {got} [{smi}]", flush=True)
        return res

    # 41. K10 with its rotation table: sphere-flag-1 lanes on rotated and
    # unrotated sphere rows and lanes of ellipsoid winner indices, against
    # shade_plain with the same rotations (exact), with and without a
    # medium; then its time against the same launch with an empty table
    rot_scene, s_r = rotated_spheres_scene(M11["k10_width"], device=dev)
    tb_r, hit_r, lanes_r, uni_r = sphere_rot_inputs(rot_scene, s_r, 141)
    rots = rot_scene.prims.sphere_rots
    n_r = hit_r[0].shape[0]
    kw_r = dict(n_mats=tb_r.n_mats, n_targets=tb_r.n_targets)
    rows = sphere_rot_table(rots, dev)[:, 0]
    rot_lane = torch.isin(hit_r[1], rows) & (lanes_r[9] > 0.5)
    n_sph = int((hit_r[9] > 0.5).sum())
    print(f"[41 K10 sphere_rots] {len(rots)} rotated rows of "
          f"{rot_scene.prims.n}; {n_r} lanes: {n_sph} sphere lanes, "
          f"{int(rot_lane.sum())} alive on rotated rows, "
          f"{int((hit_r[1] <= -2).sum())} ellipsoid winner indices",
          flush=True)
    err_rot = 0.0
    for label, medium in (("no medium", None),
                          ("synthetic medium",
                           synthetic_medium(hit_r[0], tb_r.n_mats, 142))):
        kw = dict(kw_r, has_medium=medium is not None)
        ref = shade_plain(tb_r.mtbl, tb_r.ttbl, hit_r, medium, lanes_r,
                          uni_r, sphere_rots=rots, **kw)
        out = shade_megakernel(tb_r.mtbl, tb_r.ttbl, hit_r, medium, lanes_r,
                               uni_r, sphere_rots=rots, **kw)
        err = _check(f"K10 sphere_rots vs plain ({label}): rotated checker "
                     f"spheres {M11['k10_width']}x{M11['k10_width']} camera "
                     "rays", max_errs(ref, out, BOUNCE_INT_ROWS), n_r)
        if err:
            raise AssertionError("K10 sphere_rots: not exact")
        err_rot = max(err_rot, err)
        if medium is None:
            out_rot = out
    kw0 = dict(kw_r, has_medium=False)
    out0 = shade_megakernel(tb_r.mtbl, tb_r.ttbl, hit_r, None, lanes_r,
                            uni_r, **kw0)
    moved = (out_rot[6] - out0[6]).abs() > 1e-3
    n_moved, n_stray = int((moved & rot_lane).sum()), int((moved
                                                          & ~rot_lane).sum())
    print(f"[41 K10 sphere_rots] the table changes the checker cell of "
          f"{n_moved} rotated lanes and of {n_stray} other lanes", flush=True)
    if n_moved == 0 or n_stray:
        raise AssertionError("K10 sphere_rots: the table does not act on "
                             "exactly the rotated lanes")
    calls = {"rots": lambda: shade_megakernel(
                 tb_r.mtbl, tb_r.ttbl, hit_r, None, lanes_r, uni_r,
                 sphere_rots=rots, **kw0),
             "empty": lambda: shade_megakernel(
                 tb_r.mtbl, tb_r.ttbl, hit_r, None, lanes_r, uni_r, **kw0)}
    turns = {"rots": [], "empty": []}
    for mode in ("rots", "empty", "empty", "rots"):
        turns[mode].append((_device_ms(calls[mode], "shade_kernel", 50),
                            _time_ms(calls[mode], 50)))
    ms_rot = min(x[0] for x in turns["rots"])
    host_rot = min(x[1] for x in turns["rots"])
    ms_empty = min(x[0] for x in turns["empty"])
    plain_rot = _time_ms(lambda: shade_plain(
        tb_r.mtbl, tb_r.ttbl, hit_r, None, lanes_r, uni_r, sphere_rots=rots,
        **kw0), 5, 1)
    # bytes: 10 hit, 10 lane and 8 uniform words read, 15 written a lane,
    # the tables once; operations: the shade's ~300 a lane and, for each
    # sphere lane, a compare a table row and 15 for the rotation
    bound_rot = _bound_ms(4 * (n_r * (10 + 10 + 8 + 15) + tb_r.mtbl.numel()
                               + tb_r.ttbl.numel() + 10 * len(rots)),
                          n_r * 300 + n_sph * (len(rots) + 15))
    print(f"[time] K10 with {len(rots)} rotations at {n_r} lanes: "
          f"{ms_rot:.4f} ms on the device ({host_rot:.4f} ms a call back to "
          f"back), the empty table {ms_empty:.4f}; in turns (rots, empty, "
          f"empty, rots) {turns}; shade_plain with the rotations "
          f"{plain_rot:.3f} ms; bound {bound_rot[0]:.5f} ms ({bound_rot[1]}) "
          f"[{smi}]", flush=True)
    phase_done("K10 sphere_rots")

    # 42. the ellipsoid scene's forward: the split route (K8, the
    # ellipsoids merged in torch, K10, the earth's image multiplied in)
    ell, s_e = ellipsoid_scene(M11["ell_width"], M11["ell_spp"], 50,
                               device=dev)
    r42 = forward_run("42 ellipsoid forward", ell, s_e, M11["ell_spp"], 0,
                      pallas_nearest_record, "ellipsoids.png")
    l42 = r42["launches"]
    if (not r42["finite"] or l42["pallas_nearest_record"] == 0
            or l42["shade_megakernel"] != l42["pallas_nearest_record"]
            or l42["bounce_megakernel"] or l42["iter_megakernel"]
            or l42["allpairs_nearest_record"] or l42["K10 sphere_rots"]):
        raise AssertionError("ellipsoid forward: bad image or launches")
    r42.update(_profiled(lambda: render_accumulate(ell, s_e, seed=0, spp=2),
                         pallas_nearest_record))
    print(f"[42 ellipsoid forward] profiled 2 spp: {r42['iterations']} "
          f"iterations, {r42['device_ms_per_iter']:.4f} ms of device time and "
          f"{r42['device_ops_per_iter']:.1f} device ops an iteration, busy "
          f"{r42['busy_share']:.3f}; top {r42['top_ops']}", flush=True)
    small = s_e.replace(image_width=M11["ell_checked_width"])
    with checked_launches() as st:
        render_accumulate(ell, small, seed=1, spp=1)
    err_k8 = check_stats("42 ellipsoid forward", st,
                         ("pallas_nearest_record", "shade_megakernel"))
    phase_done("ellipsoid forward")

    # 43. the ellipsoid scene's fwd+bwd: grad_render through the generic
    # differentiable bounce; kernels against plain on a smaller tile
    def tile_run(scene, settings, key, n_pix, n_smp):
        """``grad_render`` over ``n_pix`` pixels spread evenly over the
        image (the top rows of the Cornell views see only the black
        background) x ``n_smp`` samples, against a zero target."""
        n_img = settings.image_width * settings.image_height
        pix = (torch.arange(n_pix, device=dev) * n_img // n_pix).to(
            torch.int32)
        smp = torch.arange(n_smp, dtype=torch.int32)
        target = torch.zeros((n_pix, 3), device=dev)
        return lambda: grad_render(scene, settings, rng.base_key(key, dev),
                                   pix, smp, target)

    def checked_grad(label, scene, settings, key, names):
        small = tile_run(scene, settings, key, M11["checked_pixels"],
                         M11["checked_samples"])
        with checked_launches() as st:
            l_k, g_k = small()
        torch.cuda.synchronize()
        err = check_stats(label, st, names)
        with plain_kernels():
            l_p, g_p = small()
        lk, lp = leaves(g_k), leaves(g_p)
        worst = _grads_close({k: v for k, v in lp.items() if v is not None
                              and v.is_floating_point()}, lk)
        rel = abs(float(l_k) - float(l_p)) / abs(float(l_p))
        print(f"[{label} vs plain] {M11['checked_pixels']} pixels x "
              f"{M11['checked_samples']} samples: loss {float(l_k):.7f} vs "
              f"{float(l_p):.7f} (rel {rel:.3g}, tolerance 1e-6); gradients' "
              f"worst L2 |kernels - plain| / |plain| {worst:.3g} (tolerance "
              f"{GRAD_RTOL})", flush=True)
        if rel > 1e-6 or worst > GRAD_RTOL:
            raise AssertionError(f"{label}: kernels against plain")
        return err, rel, worst

    def timed_grad(label, scene, settings, key, n_pix, n_smp, counter):
        run = tile_run(scene, settings, key, n_pix, n_smp)
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, g = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        peak = torch.cuda.max_memory_allocated()
        gl = {k: v for k, v in leaves(g).items()
              if v is not None and v.is_floating_point()}
        finite = all(bool(torch.isfinite(v).all()) for v in gl.values())
        res = dict(wall_s=wall, loss=float(loss), peak_bytes=peak,
                   primary_rays_per_s=n_pix * n_smp / wall, launches=got,
                   finite=finite)
        res.update(_profiled(run, counter))
        print(f"[{label}] {n_pix} pixels x {n_smp} samples, depth "
              f"{settings.max_depth}: wall {wall:.3f} s "
              f"({res['primary_rays_per_s'] / 1e6:.3f} M primary rays/s), "
              f"loss {res['loss']:.6f}, peak {peak / 2**30:.3f} GiB, "
              f"gradients finite {finite}, launches {got}; profiled: "
              f"{res['iterations']} launches of {counter.__name__} (twice the "
              f"bounces: each is checkpointed), "
              f"{res['device_ms_per_iter']:.4f} ms of device time and "
              f"{res['device_ops_per_iter']:.1f} device "
              f"ops a launch, busy {res['busy_share']:.3f}; top "
              f"{res['top_ops']} [{smi}]", flush=True)
        return res, g

    err43, rel43, worst43 = checked_grad(
        "43 ellipsoid fwd+bwd", ell, s_e, 4, ("pallas_nearest_record",))
    r43, g43 = timed_grad("43 ellipsoid fwd+bwd", ell, s_e, 4,
                          DEMO2_GRAD["pixels"], DEMO2_GRAD["samples"],
                          pallas_nearest_record)
    ell_leaves = {k: v for k, v in leaves(g43).items()
                  if k.startswith("ellipsoids.")}
    ell_fin = all(bool(torch.isfinite(v).all()) for v in ell_leaves.values())
    if (not r43["finite"] or not ell_fin or len(ell_leaves) != 7
            or not any(bool((v != 0).any()) for v in ell_leaves.values())
            or r43["launches"]["pallas_nearest_record"] == 0
            or r43["launches"]["shade_megakernel"]
            or r43["launches"]["bounce_megakernel"]
            or r43["launches"]["iter_megakernel"]):
        raise AssertionError("ellipsoid fwd+bwd: not finite, no ellipsoid "
                             "gradient, or a kernel missing")
    # d(mean hit t)/d(radius) against a central difference, over the
    # camera rays whose winner is the same at r - eps, r and r + eps
    n_t = M11["hit_t_rays"]
    comps, _ = camera_rays(ell, s_e, n_t, 143)
    o_t, d_t, tm_t = comps[0:3].T, comps[3:6].T, comps[6]
    tables = integrator.generic_tables(ell, s_e, diff=True)
    params, statics = partition(ell)

    def hit_t(radius):
        ell_r = dataclasses.replace(params.ellipsoids, radius=radius)
        sc = combine(dataclasses.replace(params, ellipsoids=ell_r), statics)
        t, idx, *_ = integrator.surface_hit_diff(sc, tables, o_t, d_t, tm_t)
        return t, idx

    r0 = params.ellipsoids.radius.detach()
    eps = 1e-3 * float(r0.min())
    fd_t, ad_t = [], []
    for e in range(r0.shape[0]):
        step = torch.zeros_like(r0)
        step[e] = eps
        with torch.no_grad():
            tp, ip = hit_t(r0 + step)
            tm_, im = hit_t(r0 - step)
            t0_, i0 = hit_t(r0)
        keep = (ip == i0) & (im == i0) & (i0 == -2 - e)
        rr = r0.clone().requires_grad_(True)
        t_ad, _ = hit_t(rr)
        mean_ad = torch.where(keep, t_ad, 0.0).sum() / keep.sum()
        ad_t.append(float(torch.autograd.grad(mean_ad, rr)[0][e]))
        fd_t.append(float(((torch.where(keep, tp, 0.0).sum()
                            - torch.where(keep, tm_, 0.0).sum())
                           / keep.sum()) / (2 * eps)))
    ok_t = all(abs(a - f) <= 0.02 * abs(f) + 1e-4 for a, f in zip(ad_t, fd_t))
    print(f"[43 hit t] d(mean hit t)/d(radius) per ellipsoid over its rays "
          f"of {n_t} camera rays: autograd {ad_t} vs central difference "
          f"(eps {eps:.4g}) {fd_t}; within rtol 0.02: {ok_t}", flush=True)
    if not ok_t:
        raise AssertionError("ellipsoid radius gradient against FD")
    phase_done("ellipsoid fwd+bwd")

    # 44. demo2 forward at the scene's own settings
    demo2, s_d = demo2_scene(device=dev)
    print(f"[44 demo2] {demo2.prims.n} surface rows in "
          f"{demo2.prims.kind.shape[0]} (segments "
          f"{demo2.prims.kind_segments}), media densities "
          f"{demo2.volumes.density.tolist()}, {demo2.materials.kind.shape[0]}"
          f" materials, rotated uv spheres "
          f"{[r for r, _ in demo2.prims.sphere_rots]}",
          flush=True)
    r44 = forward_run("44 demo2 forward", demo2, s_d, DEMO2_FWD_SPP,
                      DEMO2_SEED, allpairs_nearest_record, "demo2.png")
    l44 = r44["launches"]
    if (not r44["finite"] or l44["allpairs_nearest_record"] == 0
            or l44["shade_megakernel"] != l44["allpairs_nearest_record"]
            or l44["K11 candidate"] != l44["allpairs_nearest_record"]
            or l44["marble_stripe_pallas"] == 0 or l44["K11b"]
            or l44["bounce_megakernel"] or l44["iter_megakernel"]
            or l44["pallas_nearest_record"] or l44["K10 sphere_rots"]):
        raise AssertionError("demo2 forward: bad image or launches")
    r44.update(_profiled(lambda: render_accumulate(
        demo2, s_d, seed=DEMO2_SEED, spp=M11["demo2_prof_spp"]),
        allpairs_nearest_record))
    print(f"[44 demo2 forward] profiled {M11['demo2_prof_spp']} spp: "
          f"{r44['iterations']} iterations, {r44['device_ms_per_iter']:.4f} ms"
          f" of device time and {r44['device_ops_per_iter']:.1f} device ops an"
          f" iteration, busy {r44['busy_share']:.3f}; top {r44['top_ops']} "
          f"[{smi}]", flush=True)
    with checked_launches() as st:
        acc1, _ = render_accumulate(demo2, s_d, seed=1, spp=1)
    if not bool(torch.isfinite(acc1).all()):
        raise AssertionError("checked demo2: not finite")
    err_d = check_stats("44 demo2 forward", st, (
        "allpairs_nearest_record", "pallas_volume_candidates",
        "shade_megakernel", "marble_stripe_pallas"))
    phase_done("demo2 forward")

    # 45. demo2 fwd+bwd: grad_render over every float leaf (K9, the keyed
    # K11, the atlas gradient K13), kernels against plain on a smaller
    # tile, and the fog's density gradient against a central difference
    err45, rel45, worst45 = checked_grad(
        "45 demo2 fwd+bwd", demo2, s_d, 5,
        ("allpairs_nearest_record", "pallas_volume_crossings_keyed",
         "image_grad_pallas"))
    r45, g45 = timed_grad("45 demo2 fwd+bwd", demo2, s_d, 5,
                          DEMO2_GRAD["pixels"], DEMO2_GRAD["samples"],
                          allpairs_nearest_record)
    l45 = r45["launches"]
    dens45 = g45.volumes.density
    if (not r45["finite"] or l45["allpairs_nearest_record"] == 0
            or l45["K11 keyed"] == 0 or l45["image_grad_pallas"] == 0
            or l45["shade_megakernel"] or l45["bounce_megakernel"]
            or l45["iter_megakernel"] or not bool(dens45[0] != 0)
            or not bool((g45.textures.images != 0).any())):
        raise AssertionError("demo2 fwd+bwd: not finite, a kernel missing, "
                             "or no fog or texel gradient")
    print(f"[45 demo2 fwd+bwd] d loss / d density (fog, blue) "
          f"{dens45.tolist()}; texels with a gradient "
          f"{int((g45.textures.images != 0).any(-1).sum())}", flush=True)
    p_d, s_dd = partition(demo2)
    pix_f = (torch.arange(M11["fog_pixels"], device=dev)
             * (s_d.image_width * s_d.image_height) // M11["fog_pixels"]
             ).to(torch.int32)
    smp_f = torch.arange(M11["fog_samples"], dtype=torch.int32)

    def fog_mean(dens, seed):
        vol = dataclasses.replace(p_d.volumes, density=dens)
        sc = combine(dataclasses.replace(p_d, volumes=vol), s_dd)
        return torch.mean(render_tile(sc, s_d, rng.base_key(seed, dev),
                                      pix_f, smp_f, differentiable=True))

    rho = p_d.volumes.density.detach()
    gs = []
    for seed in range(M11["fog_ad_seeds"]):
        dd = rho.clone().requires_grad_(True)
        gs.append(torch.autograd.grad(fog_mean(dd, seed), dd)[0].tolist())
    g_ad = np.mean(gs, axis=0)
    h = 0.3 * float(rho[0])
    fds = []
    with torch.no_grad():
        for seed in range(M11["fog_ad_seeds"],
                          M11["fog_ad_seeds"] + M11["fog_fd_seeds"]):
            up, dn = rho.clone(), rho.clone()
            up[0] += h
            dn[0] -= h
            fds.append((float(fog_mean(up, seed)) - float(fog_mean(dn, seed)))
                       / (2 * h))
    g_fd = float(np.mean(fds))
    se_fd = float(np.std(fds) / np.sqrt(len(fds)))
    ok_f = (abs(g_fd) > 3 * se_fd
            and abs(g_ad[0] - g_fd) <= max(0.35 * abs(g_fd), 3 * se_fd))
    print(f"[45 fog density] d(mean radiance)/d(fog density) over "
          f"{M11['fog_pixels']} pixels x {M11['fog_samples']} samples: "
          f"score-function {g_ad[0]:.5g} ({M11['fog_ad_seeds']} seeds: "
          f"{[g[0] for g in gs]}) vs central difference at +-{h:.3g} "
          f"{g_fd:.5g} ({M11['fog_fd_seeds']} seeds, standard error "
          f"{se_fd:.3g}); the blue medium's {g_ad[1]:.5g}; within rtol 0.35 "
          f"(or 3 standard errors) and beyond 3 standard errors of 0: {ok_f}",
          flush=True)
    if not ok_f:
        raise AssertionError("demo2 fog density gradient against FD")
    phase_done("demo2 fwd+bwd")

    runs = (l42, r43["launches"], l44, l45)
    no_lib = None   # no single PyTorch call computes the shade
    kernel = {"name": "shade_megakernel_sphere_rots", "route": "cuda",
              "source": "raytrace_tpu_torch/csrc/shade_kernel.cu",
              "replaces": "raytrace_tpu/ops/pallas/bounce_kernel.py:616",
              "launches": sum(x["K10 sphere_rots"] for x in runs),
              "max_abs_err": err_rot, "ms": ms_rot, "host_ms": host_rot,
              "plain_ms": plain_rot, "bound_ms": bound_rot[0],
              "bound_by": bound_rot[1], "library_ms": no_lib,
              "empty_table_ms": ms_empty, "n_rots": len(rots),
              "note": "the sphere_rots input of K10; no route passes it "
                      "(the drivers precompute the uv), so its main-path "
                      "launches are 0"}
    summary = dict(k10_sphere_rots=dict(turns=turns, moved=n_moved),
                   ellipsoid_forward=r42, ellipsoid_fwd_bwd=r43,
                   ellipsoid_hit_t=dict(ad=ad_t, fd=fd_t),
                   demo2_forward=r44, demo2_fwd_bwd=r45,
                   demo2_checked=dict(loss_rel=rel45, grad_worst=worst45),
                   fog_density=dict(ad=g_ad.tolist(), fd=g_fd, se=se_fd))
    return dict(summary=summary, kernel=kernel,
                err_k8=max(err_k8, err43), err_k9=err_d,
                k8_launches=sum(x["pallas_nearest_record"] for x in runs),
                k9_launches=sum(x["allpairs_nearest_record"] for x in runs),
                k10_launches=sum(x["shade_megakernel"] for x in runs),
                k11_launches=sum(x["pallas_volume_crossings"] for x in runs),
                k12_launches=sum(x["marble_stripe_pallas"] for x in runs),
                k13_launches=sum(x["image_grad_pallas"] for x in runs))


# bigmesh-512 in the smoke: K9 is held on a fixed sample of each launch's
# lanes; the fwd+bwd against the plain kernels and the albedo's central
# difference run on a tile of checked_pixels x checked_samples; the
# profiled forward renders prof_spp samples
BIG = dict(k9_sample=1 << 13, checked_pixels=1 << 12, checked_samples=1,
           prof_spp=4, fd_eps=0.02)


@contextlib.contextmanager
def _driver_spies():
    """Inside the block ``{name: calls}`` counts the calls of the render
    drivers, ``trace_wavefront_diff`` and ``trace``, and ``["bvh_build_s"]``
    lists the build seconds of every ``pack_bvh`` of the split path."""
    from raytrace_tpu_torch.render import integrator, render
    calls = {"bvh_build_s": []}
    spied = [(render, "trace_wavefront"),
             (render, "trace_wavefront_stationary"),
             (render, "trace_wavefront_sorted"),
             (integrator, "trace_wavefront_diff"), (integrator, "trace")]
    saved = [(m, n, getattr(m, n)) for m, n in spied] + [
        (integrator, "pack_bvh", integrator.pack_bvh)]

    def spy(name, real):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        return wrapped

    def pack_spy(*a, **k):
        bvh = saved[-1][2](*a, **k)
        calls["bvh_build_s"].append(bvh.build_s)
        return bvh

    for m, n, real in saved[:-1]:
        setattr(m, n, spy(n, real))
    integrator.pack_bvh = pack_spy
    try:
        yield calls
    finally:
        for m, n, real in saved:
            setattr(m, n, real)


@contextlib.contextmanager
def _same_tree(bvh):
    """Inside the block the split path's ``pack_bvh`` returns ``bvh``, the
    tree phase 46 built over the same rows, in place of building it again:
    for the checks of phases 48 and 49, whose geometry does not move (the
    timed and profiled runs build theirs, as every driver call does)."""
    from raytrace_tpu_torch.render import integrator
    real = integrator.pack_bvh
    integrator.pack_bvh = lambda prims, tbl, n_prims: bvh
    try:
        yield
    finally:
        integrator.pack_bvh = real


def _bigmesh_phases(smi, phase_done, dev) -> dict:
    """Phases 46-50 (bigmesh-512: ``tools/bench_bigmesh.py`` at 512 x 512
    latitude-longitude cells, 523,264 triangles, read back from an .obj
    file by the native parser; then ``engine_report`` against the launch
    counters on every route of the smoke) on ``dev``.  Returns the
    summary for the JSON line, K9's and K10's launches on these routes,
    K9's largest error and its numbers at 523,328 rows for its entry of
    the kernels line."""
    import tempfile

    import numpy as np
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        grad_render, leaves, partition, render_loss,
    )
    from raytrace_tpu_torch.ops.allpairs_kernel import (
        allpairs_nearest_plain, allpairs_nearest_record,
    )
    from raytrace_tpu_torch.ops._build import native_library
    from raytrace_tpu_torch.ops.bounce_kernel import shade_megakernel
    from raytrace_tpu_torch.render import integrator
    from raytrace_tpu_torch.render.image import write_image
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.scene.obj import parse_obj
    from raytrace_tpu_torch.testing import (
        BIGMESH, BIGMESH_GRAD, NEAREST_INT_ROWS, bigmesh_mesh, bigmesh_scene,
        camera_rays, checked_launches, max_errs, mesh_obj_text,
        next_split_rays, plain_kernels,
    )
    counters = _route_counters()

    def reset():
        for c in counters.values():
            c.launches = 0

    def read():
        return {k: c.launches for k, c in counters.items()}

    # 46. the mesh as .obj text, written to a file and read back by the
    # native parser (equal to the Python parser's mesh and to the
    # numbers written), compiled on the card, and the split path's BVH
    n_lat, n_lon = BIGMESH["n_lat"], BIGMESH["n_lon"]
    written = bigmesh_mesh(rt, n_lat, n_lon)
    v, f = written.vertices, written.faces
    t0 = time.perf_counter()
    native_library("objparse")      # the g++ build, timed apart
    gxx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    text = mesh_obj_text(v, f)
    text_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bigmesh.obj")
        with open(path, "w") as fh:
            fh.write(text)
        t0 = time.perf_counter()
        with open(path) as fh:
            data = fh.read()
        mesh = parse_obj(data, native=True)
        native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = parse_obj(data, native=False)
    py_s = time.perf_counter() - t0
    same = (all(np.array_equal(getattr(mesh, k), getattr(py, k))
                for k in ("vertices", "uv", "faces", "uv_faces"))
            and np.array_equal(mesh.vertices, v)
            and np.array_equal(mesh.faces, f))
    t0 = time.perf_counter()
    scene, s = bigmesh_scene(n_lat, n_lon, mesh=mesh, device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    p = scene.prims
    tb = integrator.split_tables(scene, s)
    bvh = tb.bvh
    bvh_bytes = 4 * (bvh.nodes.numel() + bvh.rows.numel())
    print(f"[46 bigmesh parse] {f.shape[0]} triangles, {len(text) / 1e6:.1f} "
          f"MB of .obj text made in {text_s:.2f} s; the native parser's g++ "
          f"build {gxx_s:.2f} s; native parse (file read "
          f"included) {native_s:.3f} s, Python parse {py_s:.3f} s "
          f"({py_s / native_s:.1f}x), meshes equal and equal to the numbers "
          f"written: {same}; compile_scene on the card {compile_s:.3f} s: "
          f"{p.n} surface rows in {p.kind.shape[0]} (segments "
          f"{p.kind_segments}, BVH mode {scene.bvh is not None}); pack_bvh "
          f"{bvh.build_s:.3f} s: depth {bvh.depth} of {32}, {bvh.n_nodes} "
          f"nodes, {bvh_bytes / 2**20:.1f} MiB of nodes and leaf rows, "
          f"triangle-only walk {bvh.tri_only} [{smi}]", flush=True)
    if (not same or scene.bvh is not None or p.kind_segments is None
            or p.n != f.shape[0] + 2):
        raise AssertionError("bigmesh: parse or compile")
    phase_done("bigmesh parse and build")

    # 47. K9 over the 523,328 rows against its plain version on a fixed
    # sample of the lanes of the camera rays and of their second bounce,
    # exactly; its time, visits and bound
    n_pix = s.image_width * s.image_height
    kw = dict(n_prims=tb.n_prims, t_min=tb.t_min, has_motion=tb.has_motion)
    k = BIG["k9_sample"]
    pick = (torch.arange(k) * n_pix // k).to(dev)
    comps, uni = camera_rays(scene, s, n_pix, 471)
    err9 = 0.0

    def k9_check(label, c):
        rays = tuple(c.unbind(0))
        out = allpairs_nearest_record(tb.ptbl, tb.bvh, *rays, **kw)
        ref = allpairs_nearest_plain(tb.ptbl, *(x[pick] for x in rays), **kw)
        n_int, err, _ = max_errs(ref, tuple(x[pick] for x in out),
                                 NEAREST_INT_ROWS)
        n_hit = int((out[1][pick] >= 0).sum())
        print(f"[47 K9 vs plain] {label}: {k} of {n_pix} lanes "
              f"({n_hit} hits), exact rows differ on {n_int} lanes, max |err| "
              f"{err:.3g}", flush=True)
        if n_int or err or n_hit == 0:
            raise AssertionError(f"K9 at {tb.n_prims} rows: {label}")
        return out, err

    out_c, e = k9_check("camera rays", comps)
    err9 = max(err9, e)
    hit = integrator.surface_hit(tb, comps[0:3], comps[3:6], comps[6])
    ones = torch.ones(n_pix, device=dev)
    sh = shade_megakernel(tb.mtbl, tb.ttbl, hit, None,
                          (*comps[0:6], ones, ones, ones, ones), uni,
                          n_mats=tb.n_mats, n_targets=tb.n_targets,
                          has_medium=False)
    nxt, _, _, alive = next_split_rays(comps, sh, 472, 1)
    nxt[0:3] = torch.where(alive, nxt[0:3], 3e18)
    _, e = k9_check("second bounce", nxt.contiguous())
    err9 = max(err9, e)
    rays = tuple(comps.unbind(0))
    call = lambda: allpairs_nearest_record(tb.ptbl, tb.bvh, *rays, **kw)
    ms9 = _device_ms(call, "nearest_kernel", 20)
    host9 = _time_ms(call, 20)
    plain9 = _time_ms(lambda: allpairs_nearest_plain(
        tb.ptbl, *(x[pick] for x in rays), **kw), 1, 1)
    out_v, visits, touched9, (t_nodes, t_rows) = _walk_touch(tb, rays, kw)
    hit_v = out_v[1] >= 0
    vis = visits.double()
    nodes_v, rows_v = float(vis[0].mean()), float(vis[1].mean())
    bound9 = _bound_ms(4 * n_pix * (7 + 9) + touched9,
                       n_pix * (BOX_OPS * nodes_v + ROW_OPS * rows_v))
    k9 = dict(rows=tb.n_prims, lanes=n_pix, ms=ms9, host_ms=host9,
              plain_ms_sample=plain9, sample_lanes=k, bound_ms=bound9[0],
              bound_by=bound9[1], touched_bytes=touched9,
              touched_nodes=t_nodes, touched_rows=t_rows,
              box_tests=nodes_v, row_tests=rows_v,
              hit_share=float(hit_v.double().mean()),
              hit_box_tests=float(vis[0][hit_v].mean()),
              hit_row_tests=float(vis[1][hit_v].mean()),
              max_box_tests=int(visits[0].max()),
              max_row_tests=int(visits[1].max()))
    print(f"[47 time] K9 at {tb.n_prims} rows: {ms9:.4f} ms on the device "
          f"({host9:.4f} ms a call back to back) at {n_pix} camera rays; its "
          f"plain version {plain9:.3f} ms at {k} of them; a ray makes "
          f"{nodes_v:.2f} box tests and {rows_v:.2f} row tests, a ray that "
          f"hits ({k9['hit_share']:.4f} of them) {k9['hit_box_tests']:.2f} "
          f"and {k9['hit_row_tests']:.2f}, the most {k9['max_box_tests']} and "
          f"{k9['max_row_tests']}; bound {bound9[0]:.4f} ms ({bound9[1]}: "
          f"rays and the {touched9 / 1e6:.2f} MB of the {t_nodes} nodes and "
          f"{t_rows} rows read, of {bvh_bytes / 1e6:.1f} MB, {BOX_OPS} "
          f"operations a box test, {ROW_OPS} a row test) [{smi}]", flush=True)
    phase_done("bigmesh K9")

    with _driver_spies() as calls:
        # 48. the forward: render_accumulate at the tool's own settings
        # (512 x 512, 16 spp, depth 8): the sorted driver, the split path,
        # K9 and K10 alone
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        acc, total = render_accumulate(scene, s, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        l48 = read()
        l48["drivers"] = {k_: v_ for k_, v_ in calls.items()
                          if k_ != "bvh_build_s"}
        build48 = list(calls["bvh_build_s"])
        peak = torch.cuda.max_memory_allocated()
        img = (acc / total).reshape(s.image_height, s.image_width, 3)
        finite = bool(torch.isfinite(img).all())
        write_image(os.path.join(OUT_DIR, "bigmesh.png"), img.cpu().numpy())
        n_rays = n_pix * s.samples_per_pixel
        r48 = dict(wall_s=wall, primary_rays_per_s=n_rays / wall,
                   iterations=l48["K9"], launches=l48, peak_bytes=peak,
                   bvh_build_s=build48, finite=finite,
                   mean=float(img.mean()))
        print(f"[48 bigmesh forward] {s.image_width}x{s.image_height} "
              f"{s.samples_per_pixel} spp depth {s.max_depth}: wall "
              f"{wall:.3f} s ({n_rays / wall / 1e6:.3f} M primary rays/s), of "
              f"which pack_bvh {sum(build48):.3f} s; {l48['K9']} iterations, "
              f"peak {peak / 2**30:.3f} GiB, mean {r48['mean']:.6f}, finite "
              f"{finite}, launches {l48} [{smi}]", flush=True)
        if (not finite or l48["K9"] == 0 or l48["K10"] != l48["K9"]
                or any(l48[x] for x in ("A", "B", "B mesh", "K8"))
                or l48["drivers"].get("trace_wavefront_sorted") != 1):
            raise AssertionError("bigmesh forward: bad image, launches or "
                                 "driver")
        reset()
        r48.update(_profiled(lambda: render_accumulate(
            scene, s, seed=0, spp=BIG["prof_spp"]), allpairs_nearest_record))
        print(f"[48 bigmesh forward] profiled {BIG['prof_spp']} spp: "
              f"{r48['iterations']} iterations, {r48['device_ms_per_iter']:.4f}"
              f" ms of device time and {r48['device_ops_per_iter']:.1f} device "
              f"ops an iteration, busy {r48['busy_share']:.3f} (pack_bvh "
              f"{sum(calls['bvh_build_s']):.3f} s of the wall); top "
              f"{r48['top_ops']} [{smi}]", flush=True)
        with checked_launches(sample=k) as st, _same_tree(bvh):
            acc1, _ = render_accumulate(scene, s, seed=1, spp=1)
        for name in ("allpairs_nearest_record", "shade_megakernel"):
            x = st[name]
            print(f"[48 checked] {name}: {x['launches']} launches of a 1 spp "
                  f"render{' on ' + str(k) + ' lanes each' if name.startswith('allpairs') else ''}"
                  f", exact rows differ on {x['n_int']} lanes, max |err| "
                  f"{x['err']:.3g}", flush=True)
            if x["launches"] == 0 or x["n_int"] or x["err"]:
                raise AssertionError(f"bigmesh forward: {name} against plain")
            err9 = max(err9, x["err"]) if name.startswith("allpairs") \
                else err9
        if not bool(torch.isfinite(acc1).all()):
            raise AssertionError("checked bigmesh render: not finite")
        phase_done("bigmesh forward")

        # 49. grad_render over 2^16 pixels spread over the image x 4
        # samples, to every leaf: K9 through DiffSurfaceHit (forward and
        # the checkpoint's replay), the torch backward
        def tile(n_p, n_s, key):
            px = (torch.arange(n_p, device=dev) * n_pix // n_p).to(
                torch.int32)
            sm = torch.arange(n_s, dtype=torch.int32)
            tg = torch.zeros((n_p, 3), device=dev)
            return px, sm, tg, rng.base_key(key, dev)

        px, sm, tg, key = tile(BIG["checked_pixels"], BIG["checked_samples"],
                               7)
        with checked_launches(sample=k) as st, _same_tree(bvh):
            l_k, g_k = grad_render(scene, s, key, px, sm, tg)
        x = st["allpairs_nearest_record"]
        print(f"[49 checked] allpairs_nearest_record: {x['launches']} launches"
              f" on {BIG['checked_pixels']} pixels x "
              f"{BIG['checked_samples']} samples, exact rows differ on "
              f"{x['n_int']} lanes, max |err| {x['err']:.3g}", flush=True)
        if x["launches"] == 0 or x["n_int"] or x["err"]:
            raise AssertionError("bigmesh fwd+bwd: K9 against plain")
        with plain_kernels(), _same_tree(bvh):
            l_p, g_p = grad_render(scene, s, key, px, sm, tg)
        lk, lp = leaves(g_k), leaves(g_p)
        worst = _grads_close({n: g for n, g in lp.items() if g is not None
                              and g.is_floating_point()}, lk)
        rel = abs(float(l_k) - float(l_p)) / abs(float(l_p))
        print(f"[49 vs plain] {BIG['checked_pixels']} pixels x "
              f"{BIG['checked_samples']} samples: loss {float(l_k):.7f} vs "
              f"{float(l_p):.7f} (rel {rel:.3g}, tolerance 1e-6); gradients' "
              f"worst L2 |kernels - plain| / |plain| {worst:.3g} (tolerance "
              f"{GRAD_RTOL})", flush=True)
        if rel > 1e-6 or worst > GRAD_RTOL:
            raise AssertionError("bigmesh fwd+bwd: kernels against plain")
        # the albedo's central difference on the same tile and keys (the
        # loss is a polynomial in the albedo)
        params, statics = partition(scene)

        def loss_at(c):
            c0 = params.textures.c0.detach().clone()
            c0[0, 0] = c
            pr = dataclasses.replace(params, textures=dataclasses.replace(
                params.textures, c0=c0))
            with torch.no_grad(), _same_tree(bvh):
                return float(render_loss(pr, statics, s, key, px, sm, tg))

        c_0 = float(params.textures.c0[0, 0].detach())
        eps = BIG["fd_eps"]
        fd = (loss_at(c_0 + eps) - loss_at(c_0 - eps)) / (2 * eps)
        gv = float(g_k.textures.c0[0, 0])
        print(f"[49 finite difference] d loss / d mesh albedo (red, "
              f"{c_0}): gradient {gv:.6g}, central difference {fd:.6g} (eps "
              f"{eps}), rel diff {abs(gv - fd) / abs(fd):.3g} (bound "
              f"{FD_RTOL})", flush=True)
        if gv == 0.0 or not abs(gv - fd) <= FD_RTOL * abs(fd):
            raise AssertionError("bigmesh fwd+bwd: albedo against FD")
        px, sm, tg, key = tile(BIGMESH_GRAD["pixels"],
                               BIGMESH_GRAD["samples"], 5)
        calls.clear()
        calls["bvh_build_s"] = []
        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, g = grad_render(scene, s, key, px, sm, tg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        l49 = read()
        l49["drivers"] = {k_: v_ for k_, v_ in calls.items()
                          if k_ != "bvh_build_s"}
        build49 = list(calls["bvh_build_s"])
        peak = torch.cuda.max_memory_allocated()
        gl = {n: t for n, t in leaves(g).items()
              if t is not None and t.is_floating_point()}
        finite = all(bool(torch.isfinite(t).all()) for t in gl.values())
        # the corners p0 get a zero gradient, in the JAX package too: a
        # lambertian hit's weight (albedo, the cosine sampling's pdf over
        # its detached value) does not depend on the hit point, so the
        # rows' position moves only which row a ray hits; e1 and e2 turn
        # the normal inside that weight
        moved = {n: bool((gl[n] != 0).any())
                 for n in ("prims.e1", "prims.e2", "textures.c0")}
        p0_max = float(gl["prims.p0"].abs().max())
        n_rays = BIGMESH_GRAD["pixels"] * BIGMESH_GRAD["samples"]
        r49 = dict(wall_s=wall, loss=float(loss), peak_bytes=peak,
                   primary_rays_per_s=n_rays / wall, launches=l49,
                   bvh_build_s=build49, finite=finite, moved=moved,
                   p0_max=p0_max)
        reset()
        r49.update(_profiled(lambda: grad_render(scene, s, key, px, sm, tg),
                             allpairs_nearest_record))
        print(f"[49 bigmesh fwd+bwd] grad_render on {BIGMESH_GRAD['pixels']} "
              f"pixels x {BIGMESH_GRAD['samples']} samples, depth "
              f"{s.max_depth}: wall {wall:.3f} s ({n_rays / wall / 1e6:.3f} M "
              f"primary rays/s), of which pack_bvh {sum(build49):.3f} s; loss "
              f"{float(loss):.6f}, peak {peak / 2**30:.3f} GiB, gradients "
              f"finite {finite}, non-zero {moved}, max |d loss / d p0| "
              f"{p0_max:.3g}, launches {l49}; profiled: "
              f"{r49['iterations']} K9 launches (twice the bounces: each is "
              f"checkpointed), {r49['device_ms_per_iter']:.4f} ms of device "
              f"time and {r49['device_ops_per_iter']:.1f} device ops a launch,"
              f" busy {r49['busy_share']:.3f}; top {r49['top_ops']} [{smi}]",
              flush=True)
        if (not finite or not all(moved.values()) or l49["K9"] == 0
                or any(l49[x] for x in ("A", "B", "B mesh", "K8", "K10"))):
            raise AssertionError("bigmesh fwd+bwd: gradients or launches")
        phase_done("bigmesh fwd+bwd")

    # 50. engine_report against the launch counters on every route
    routes = _route_reports(smi, dev, reset, read, dict(
        bigmesh_forward=(scene, s, False, 1, l48),
        bigmesh_grad_render=(scene, s, True, 1, l49)))
    phase_done("engine_report")

    runs = (l48, l49)
    summary = dict(parse=dict(native_s=native_s, python_s=py_s,
                              gxx_s=gxx_s, text_s=text_s, equal=same),
                   compile_s=compile_s,
                   bvh=dict(build_s=bvh.build_s, depth=bvh.depth,
                            nodes=bvh.n_nodes, bytes=bvh_bytes),
                   k9=k9, forward=r48, fwd_bwd=r49,
                   checked=dict(loss_rel=rel, grad_worst=worst, fd=fd,
                                grad=gv),
                   routes=routes)
    return dict(summary=summary, err_k9=err9, k9=k9,
                k9_launches=sum(x["K9"] for x in runs),
                k10_launches=sum(x["K10"] for x in runs))


def _route_counters() -> dict:
    """The launch counter of each kernel, under the names
    ``engine_report`` gives them."""
    from raytrace_tpu_torch.ops.allpairs_kernel import allpairs_nearest_record
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_bwd_kernel import (
        bounce_bwd_megakernel_reduced,
    )
    from raytrace_tpu_torch.ops.bounce_kernel import (
        bounce_megakernel, shade_megakernel,
    )
    from raytrace_tpu_torch.ops.image_grad_kernel import image_grad_pallas
    from raytrace_tpu_torch.ops.intersect_kernel import pallas_nearest_record
    from raytrace_tpu_torch.ops.iter_kernel import iter_mega_ap, iter_megakernel
    from raytrace_tpu_torch.ops.texture_kernel import marble_stripe_pallas
    from raytrace_tpu_torch.ops.volume_kernel import (
        pallas_volume_crossings, pallas_volume_crossings_bcast,
    )
    return {"A": bounce_megakernel, "B": iter_megakernel,
            "B mesh": iter_mega_ap, "K8": pallas_nearest_record,
            "K9": allpairs_nearest_record, "K10": shade_megakernel,
            "K11": pallas_volume_crossings,
            "K11b": pallas_volume_crossings_bcast,
            "K12": marble_stripe_pallas, "K13": image_grad_pallas,
            "K5": bounce_bwd_regen_pre_reduced,
            "K7": bounce_bwd_megakernel_reduced}


def _report_agrees(rep: dict, got: dict, grad_render: bool = False) -> list:
    """The stages where ``engine_report``'s ``rep`` disagrees with a run's
    launches ``got`` (and the drivers it called, ``got["drivers"]``)."""
    bad = []
    drivers = got["drivers"]
    driver_fn = {"queue": "trace_wavefront",
                 "stationary": "trace_wavefront_stationary",
                 "sorted": "trace_wavefront_sorted",
                 "diff-wavefront": ("trace" if grad_render
                                    else "trace_wavefront_diff")}
    if not drivers.get(driver_fn[rep["driver"]]):
        bad.append("driver")
    fwd = {"kernel-A": got["A"] > 0 and got["B"] + got["B mesh"] == 0,
           "kernel-B": got["B"] + got["B mesh"] > 0 and got["A"] == 0
           and got["K10"] == 0,
           "split": got["K10"] > 0 and got["A"] + got["B"] + got["B mesh"]
           == 0,
           "generic": got["K10"] + got["A"] + got["B"] + got["B mesh"] == 0
           and got["K8"] + got["K9"] > 0}
    if not fwd[rep["forward"]]:
        bad.append("forward")
    isect = {"in-kernel": got["K8"] + got["K9"] == 0,
             "K8": got["K8"] > 0 and got["K9"] == 0,
             "K9": got["K9"] > 0 and got["K8"] == 0}
    if not isect.get(rep["intersect"], False):
        bad.append("intersect")
    bwd = {None: got["K5"] + got["K7"] == 0,
           "K5": got["K5"] > 0 and got["K7"] == 0,
           "K7": got["K7"] > 0 and got["K5"] == 0,
           "autograd": got["K5"] + got["K7"] == 0}
    if not bwd[rep["backward"]]:
        bad.append("backward")
    vol = {None: got["K11"] + got["K11b"] == 0,
           "K11": got["K11"] > 0 and got["K11b"] == 0,
           "K11b": got["K11b"] > 0 and got["K11"] == 0}
    if not vol[rep["volumes"]]:
        bad.append("volumes")
    return bad


def _route_reports(smi, dev, reset, read, measured: dict) -> dict:
    """Phase 50: for each route the smoke drives, ``engine_report`` at the
    route's own settings, held against the launch counters of a run: a
    smaller run that the report says takes the same route (the report of
    the small run must equal the route's), or the run of ``measured``
    (``{label: (scene, settings, diff, rotate_k, launches)}``)."""
    import importlib
    import types
    import torch
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import (
        grad_render, loss_and_grads, partition,
    )
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        bunny_standin_scene, cornell_scene_and_settings, cornell_smoke_scene,
        demo2_scene, ellipsoid_scene, image_grad_scene, marble_light_scene,
        noise_test_scene, pawn_standin_scene,
    )
    from raytrace_tpu_torch.utils.engines import engine_report

    def fwd(scene, s):
        return lambda: render_accumulate(scene, s, seed=2)

    def fb(scene, s, lanes, spp, n_iters, rotate_k=1):
        def run():
            params, statics = partition(scene)
            n = s.image_width * s.image_height
            pix = (torch.arange(lanes, device=dev) % n).to(torch.int32)
            return loss_and_grads(params, statics, s, rng.base_key(3, dev),
                                  pix, torch.zeros((lanes, 3), device=dev),
                                  spp=spp, n_iters=n_iters, rotate_k=rotate_k)
        return run

    def gr(scene, s, n_p):
        def run():
            n = s.image_width * s.image_height
            pix = (torch.arange(n_p, device=dev) * n // n_p).to(torch.int32)
            return grad_render(scene, s, rng.base_key(4, dev), pix,
                               torch.arange(1, dtype=torch.int32),
                               torch.zeros((n_p, 3), device=dev))
        return run

    cornell, s_c = cornell_scene_and_settings(600, FWD_SPP, 50, device=dev)
    small_c = s_c.replace(image_width=128)
    mesh, s_m = bunny_standin_scene(600, MESH_SPP, 10, device=dev)
    noise, s_n = noise_test_scene(400, 100, 50, device=dev)
    image, s_i = image_grad_scene(512, device=dev)
    smoke, s_s = cornell_smoke_scene(600, 64, 50, device=dev)
    pawn, s_p = pawn_standin_scene(500, PAWN_SPP, 20, device=dev)
    marble, s_ml = marble_light_scene(400, 16, 50, device=dev)
    ell, s_e = ellipsoid_scene(600, 16, 50, device=dev)
    demo2, s_d = demo2_scene(device=dev)
    new_scenes = {}
    for name in ("demo1", "metal_test", "sphere_uv_test"):
        mod = importlib.import_module(f"raytrace_tpu_torch.scenes.{name}")
        w, spp, depth = mod.DEFAULTS
        new_scenes[name] = mod.build(types.SimpleNamespace(
            width=w, spp=spp, depth=depth, device=dev))[:2]
    demo1, s_d1 = new_scenes["demo1"]
    metal, s_mt = new_scenes["metal_test"]
    uv, s_uv = new_scenes["sphere_uv_test"]
    # (label, scene, the route's settings, diff, rotate_k, the small
    # run's settings, the small run)
    routes = [
        ("cornell forward", cornell, s_c, False, 1,
         small_c.replace(samples_per_pixel=8), None),
        ("cornell 1 spp", cornell, s_c.replace(samples_per_pixel=1), False,
         1, small_c.replace(samples_per_pixel=1), None),
        ("cornell fwd+bwd", cornell, s_c.replace(rr_depth=2), True, 1,
         None, fb(cornell, s_c.replace(rr_depth=2), 1 << 12, 2, 20)),
        ("cornell fwd+bwd rotate_k 8", cornell, s_c.replace(rr_depth=2),
         True, 8, None, fb(cornell, s_c.replace(rr_depth=2), 1 << 12, 8, 40,
                           rotate_k=8)),
        ("mesh forward", mesh, s_m, False, 1,
         s_m.replace(image_width=128, samples_per_pixel=2), None),
        ("mesh fwd+bwd", mesh, s_m.replace(rr_depth=2), True, 1, None,
         fb(mesh, s_m.replace(rr_depth=2), 1 << 12, 2, 20)),
        ("noise_test forward", noise, s_n, False, 1,
         s_n.replace(image_width=256, samples_per_pixel=1), None),
        ("image fwd+bwd", image, s_i, True, 1, None,
         fb(image, s_i, 1 << 12, 2, 20)),
        ("cornell_smoke forward", smoke, s_s, False, 1,
         s_s.replace(image_width=128, samples_per_pixel=2), None),
        ("cornell_smoke fwd+bwd", smoke, s_s.replace(rr_depth=2), True, 1,
         None, fb(smoke, s_s.replace(rr_depth=2), 1 << 12, 2, 20)),
        ("cornell_smoke grad_render", smoke, s_s, True, 1, None,
         gr(smoke, s_s, 1 << 10)),
        ("pawn forward", pawn, s_p, False, 1,
         s_p.replace(image_width=128, samples_per_pixel=1), None),
        ("marble light forward", marble, s_ml, False, 1,
         s_ml.replace(image_width=128, samples_per_pixel=1), None),
        ("ellipsoid forward", ell, s_e, False, 1,
         s_e.replace(image_width=128, samples_per_pixel=1), None),
        ("demo2 forward", demo2, s_d, False, 1,
         s_d.replace(image_width=128, samples_per_pixel=2), None),
        ("demo2 grad_render", demo2, s_d, True, 1, None, gr(demo2, s_d,
                                                           1 << 10)),
        ("demo1 forward", demo1, s_d1, False, 1,
         s_d1.replace(image_width=224, samples_per_pixel=2), None),
        ("metal_test forward", metal, s_mt, False, 1,
         s_mt.replace(image_width=224, samples_per_pixel=2), None),
        ("sphere_uv_test forward", uv, s_uv, False, 1, s_uv, None),
    ]
    out = {}
    with _driver_spies() as calls:
        for label, scene, s, diff, rot, small, run in routes:
            rep = engine_report(scene, s, diff=diff, rotate_k=rot)
            if small is not None:
                small_rep = engine_report(scene, small, rotate_k=rot)
                if small_rep != rep:
                    raise AssertionError(f"{label}: the small run's report "
                                         f"{small_rep} is not the route's")
                run = fwd(scene, small)
            reset()
            for k in list(calls):
                if k != "bvh_build_s":
                    del calls[k]
            run()
            torch.cuda.synchronize()
            got = read()
            got["drivers"] = {k: v for k, v in calls.items()
                              if k != "bvh_build_s"}
            bad = _report_agrees(rep, got, "grad_render" in label)
            out[label] = dict(report=rep, launches=got, disagree=bad)
            print(f"[50 engine_report] {label}: {rep}; launches "
                  f"{ {k: v for k, v in got.items() if v} }: "
                  f"{'agrees' if not bad else 'DISAGREES on ' + str(bad)}",
                  flush=True)
            if bad:
                raise AssertionError(f"engine_report disagrees on {label}")
    for label, (scene, s, diff, rot, got) in measured.items():
        rep = engine_report(scene, s, diff=diff, rotate_k=rot)
        bad = _report_agrees(rep, got, "grad_render" in label)
        out[label] = dict(report=rep, launches=got, disagree=bad)
        print(f"[50 engine_report] {label}: {rep}; launches "
              f"{ {k: v for k, v in got.items() if v} }: "
              f"{'agrees' if not bad else 'DISAGREES on ' + str(bad)} [{smi}]",
              flush=True)
        if bad:
            raise AssertionError(f"engine_report disagrees on {label}")
    return out


# phase 51's scenes: the seven drivers phases 1-50 do not render, each at
# its own width and depth with samples per pixel cut so that a render
# takes a few seconds (their own: cornell_box 200, quad_test and
# metal_test 100, readme_example 50, lommel_seeliger_test 500,
# sphere_uv_test 1, demo1 500)
SCENE_SPP = dict(cornell_box=64, quad_test=100, metal_test=100,
                 readme_example=50, lommel_seeliger_test=100,
                 sphere_uv_test=1, demo1=16)
# widths of phase 51's checked renders at 1 spp: pixel counts under the
# stationary driver's 16,384 and multiples of 128, so the work queue
# drives them on kernel A (16:9 at 128 px: 9,216 pixels; 1:1 at 112 px:
# 12,544)
SCENE_CHECKED_WIDTH = dict(cornell_box=112, quad_test=112, metal_test=128,
                           readme_example=128, lommel_seeliger_test=112,
                           sphere_uv_test=1, demo1=128)
# the mean brightness of phase 52's renders against PARITY.md's recorded
# reference means (scenes/parity.py: within 1% for the pixel scenes)
PARITY_CASES = ("cornell_box", "readme_example")
# phase 53's sizes: the sharded render's tile, the train step's Adam
# steps and learning rate, the red albedo's offset; phase 54's image,
# its lanes of the train step, and the workers' time limit
SHARDED_TILE = dict(pixels=1 << 16, samples=8)
TRAIN = dict(steps=5, lr=0.02, offset=0.2)
TWO_RANKS = dict(width=128, spp=16, depth=50, train_lanes=1 << 14,
                 timeout_s=300)


def _launch_counters():
    """``(reset, read)``: set every kernel's launch counter to 0; read
    them as ``{name: launches}`` (``_route_counters``' names)."""
    counters = _route_counters()

    def reset():
        for c in counters.values():
            c.launches = 0

    def read():
        return {k: c.launches for k, c in counters.items()}
    return reset, read


def _scene_phases(smi, phase_done, dev) -> dict:
    """Phases 51-52: the scene drivers and the parity script."""
    import importlib
    import types
    import torch
    import raytrace_tpu_torch as rt
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.render.integrator import LANE_ALIGN
    from raytrace_tpu_torch.render.render import (
        _stationary_fn, forward_driver, rotate_k_for, row_bands,
    )
    from raytrace_tpu_torch.scenes import parity
    from raytrace_tpu_torch.testing import checked_launches
    from raytrace_tpu_torch.utils.engines import engine_report
    reset, read = _launch_counters()

    def nonzero(got):
        return {k: v for k, v in got.items() if v}

    # 51. each new driver's build at its own width and depth: wall, rays/s,
    # launches, PNG; then a checked render of each at <= 160 px, 1 spp,
    # and demo1's first band at its own size
    runs = {}
    for name, spp in SCENE_SPP.items():
        mod = importlib.import_module(f"raytrace_tpu_torch.scenes.{name}")
        width, _, depth = mod.DEFAULTS
        scene, s, seed = mod.build(types.SimpleNamespace(
            width=width, spp=spp, depth=depth, device=dev))
        rep = engine_report(scene, s)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        img = rt.render(scene, s, seed=seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        writer = (rt.write_image if getattr(mod, "WRITER", "sqrt") == "linear"
                  else rt.write_image_sqrt)
        writer(os.path.join(OUT_DIR, f"{name}.png"), img)
        n_rays = s.image_width * s.image_height * spp
        finite = bool(torch.isfinite(img).all())
        # sphere_uv_test's one pixel is a one-lane work queue, not a
        # multiple of 128: the generic bounce, its surface hit through K8;
        # the others take the stationary driver's fused iteration
        want = ({"K8"} if name == "sphere_uv_test" else {"B"})
        ok = finite and set(nonzero(got)) == want
        runs[name] = dict(width=s.image_width, height=s.image_height, spp=spp,
                          depth=depth, wall_s=wall,
                          primary_rays_per_s=n_rays / wall, launches=got,
                          rows=int(scene.prims.kind.shape[0]),
                          mean=float(img.mean()), report=rep)
        print(f"[51 scene] {name} {s.image_width} x {s.image_height}, {spp} "
              f"spp, depth {depth}, {runs[name]['rows']} rows: wall "
              f"{wall:.3f} s, {n_rays / wall / 1e6:.3f} M primary rays/s, "
              f"launches {nonzero(got)}, image mean {float(img.mean()):.5f},"
              f" report {rep} [{smi}]", flush=True)
        if not ok:
            raise AssertionError(f"scene {name}: non-finite image or wrong "
                                 "kernels")
    phase_done("scenes")

    checked = {}
    for name in SCENE_SPP:
        mod = importlib.import_module(f"raytrace_tpu_torch.scenes.{name}")
        width, _, depth = mod.DEFAULTS
        scene, s, seed = mod.build(types.SimpleNamespace(
            width=SCENE_CHECKED_WIDTH[name], spp=1, depth=depth, device=dev))
        with checked_launches() as stats:
            rt.render(scene, s, seed=seed)
            torch.cuda.synchronize()
        ran = {k: dict(launches=v["launches"], n_int=v["n_int"],
                       err=v["err"])
               for k, v in stats.items() if v["launches"]}
        bad = {k: v for k, v in ran.items() if v["n_int"] or v["err"]}
        want = ({"pallas_nearest_record"} if name == "sphere_uv_test"
                else {"bounce_megakernel"})
        checked[name] = ran
        print(f"[51 checked] {name} {s.image_width} x {s.image_height}, 1 "
              f"spp: " + ", ".join(
                  f"{k} {v['launches']} launches, {v['n_int']} lanes "
                  f"differing, max |err| {v['err']:.3g}"
                  for k, v in ran.items()), flush=True)
        if bad or set(ran) != want:
            raise AssertionError(f"scene {name}: a kernel disagrees with its "
                                 "plain version, or another kernel ran")

    # demo1 at its main path's launch shape: the first row band of its
    # 1200 x 675 render (render_accumulate's bands) through the stationary
    # driver, rotated as the main path is (2 spp, the fewest that rotate),
    # at its own depth 50: kernel B's rotated mode, general instantiation,
    # over all 512 rows, every launch (and its planes) checked
    mod = importlib.import_module("raytrace_tpu_torch.scenes.demo1")
    width, _, depth = mod.DEFAULTS
    scene, s, seed = mod.build(types.SimpleNamespace(
        width=width, spp=2, depth=depth, device=dev))
    off, bp = row_bands(s.image_height, s.image_width)[0]
    if forward_driver(scene, bp) != "stationary":
        raise AssertionError("demo1's band does not take the stationary "
                             "driver")
    t0 = time.perf_counter()
    with checked_launches() as stats:
        _stationary_fn(scene, s, rng.base_key(seed, dev), bp, 2, 0,
                       rotate_k_for(2), off)
        torch.cuda.synchronize()
    ran = {k: dict(launches=v["launches"], n_int=v["n_int"], err=v["err"])
           for k, v in stats.items() if v["launches"]}
    checked["demo1_band"] = dict(pixels=bp, lanes=-(-bp // LANE_ALIGN)
                                 * LANE_ALIGN, depth=depth,
                                 wall_s=time.perf_counter() - t0, **ran)
    print(f"[51 checked] demo1 band 0 of {s.image_width} x "
          f"{s.image_height}: {bp} pixels, "
          f"{checked['demo1_band']['lanes']} lanes, 2 spp, depth {depth}: "
          + ", ".join(f"{k} {v['launches']} launches, {v['n_int']} lanes "
                      f"differing, max |err| {v['err']:.3g}"
                      for k, v in ran.items())
          + f" ({checked['demo1_band']['wall_s']:.1f} s with the plain "
          "version)", flush=True)
    if (set(ran) != {"iter_megakernel"}
            or any(v["n_int"] or v["err"] for v in ran.values())):
        raise AssertionError("demo1's band: kernel B disagrees with its "
                             "plain version, or another kernel ran")
    phase_done("scenes checked")

    # 52. parity at the reference's configurations: the recorded
    # brightness within 1%; the PNG comparison without reference PNGs
    results = []
    par_launches = {}
    for name in PARITY_CASES:
        reset()
        rec = parity.run_case(name, OUT_DIR, device="cuda")
        torch.cuda.synchronize()
        par_launches[name] = read()
        results.append(rec)
        print(f"[52 parity] {name} {' '.join(rec['flags'])}: wall "
              f"{rec['seconds']:.3f} s, "
              f"{rec['primary_rays_per_s'] / 1e6:.3f} M primary rays/s, mean "
              f"brightness {rec['mean_ours']:.5f} against the reference's "
              f"{rec['mean_ref_recorded']} (rel "
              f"{rec['brightness_rel_diff']:.5f}, bound "
              f"{parity.BRIGHTNESS_RTOL[rec['mode']]}), launches "
              f"{nonzero(par_launches[name])} [{smi}]", flush=True)
        if not rec["brightness_ok"]:
            raise AssertionError(f"parity {name}: brightness out of bound")
    verdict = parity.verdicts(results)
    print(f"[52 parity] verdict {json.dumps(verdict)}", flush=True)
    if "FAIL" in (verdict["parity"], verdict["brightness"]):
        raise AssertionError("parity failed")
    phase_done("parity")

    launches = [r["launches"] for r in runs.values()] + list(
        par_launches.values())
    return dict(summary=dict(scenes=runs, parity=results, verdict=verdict,
                             checked=checked),
                a_launches=sum(x["A"] for x in launches),
                k8_launches=sum(x["K8"] for x in launches),
                k10_launches=sum(x["K10"] for x in launches))


def _parallel_phases(smi, phase_done, dev) -> dict:
    """Phases 53-54: M13 at one rank over NCCL, then two processes on the
    one card over gloo."""
    import sys
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.diff.gradients import leaves, render_tile
    from raytrace_tpu_torch.entry import dryrun_multichip
    from raytrace_tpu_torch.ops.bounce_bwd_gather_kernel import (
        bounce_bwd_regen_pre_megakernel, bounce_bwd_regen_pre_reduced,
    )
    from raytrace_tpu_torch.ops.iter_kernel import iter_megakernel
    from raytrace_tpu_torch.parallel import multihost, worker
    from raytrace_tpu_torch.parallel.sharding import (
        Mesh, make_mesh, sharded_render_fn, sharded_train_step_fn,
        sharded_wavefront_render_fn,
    )
    from raytrace_tpu_torch.render.integrator import trace_wavefront_diff
    from raytrace_tpu_torch.render.render import render_accumulate
    from raytrace_tpu_torch.testing import (
        FWD_BWD, cornell_scene_and_settings, free_port, fwd_bwd_pixels,
    )
    reset, launches = _launch_counters()

    def read():
        return {k: v for k, v in launches().items() if v}

    out = {}
    # 53. one rank over NCCL: the backend of the multi-GPU path
    multihost.initialize(f"localhost:{free_port()}", 1, 0)
    backend = dist.get_backend()
    mesh = make_mesh()
    cornell, s_c = cornell_scene_and_settings(600, FWD_SPP, 50, device=dev)
    n_pix = s_c.image_width * s_c.image_height
    seed = 5
    fn = sharded_wavefront_render_fn(mesh, n_pix, FWD_SPP)
    fn(cornell, s_c, rng.base_key(seed, dev))            # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    acc = fn(cornell, s_c, rng.base_key(seed, dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    l_wave = read()
    ref, _ = render_accumulate(cornell, s_c, seed=seed, spp=FWD_SPP)
    equal = bool(torch.equal(acc[:n_pix], ref))
    out["wavefront"] = dict(wall_s=wall, backend=backend,
                            primary_rays_per_s=n_pix * FWD_SPP / wall,
                            launches=l_wave, equal=equal,
                            padding_rows=int(acc.shape[0] - n_pix))
    print(f"[53 sharded wavefront] {backend}, mesh {mesh.shape}, cornell "
          f"{s_c.image_width} x {s_c.image_height}, {FWD_SPP} spp, depth "
          f"{s_c.max_depth}: wall {wall:.3f} s, "
          f"{n_pix * FWD_SPP / wall / 1e6:.3f} M primary rays/s, launches "
          f"{l_wave}; sums equal to render_accumulate's bit for bit: {equal}"
          f" [{smi}]", flush=True)
    if not equal or backend != "nccl":
        raise AssertionError("sharded wavefront at one rank")

    n_t, n_s = SHARDED_TILE["pixels"], SHARDED_TILE["samples"]
    pix = (torch.arange(n_t) * n_pix // n_t).to(torch.int32)
    smp = torch.arange(n_s, dtype=torch.int32)
    key = rng.base_key(seed, dev)
    t0 = time.perf_counter()
    tile = sharded_render_fn(mesh)(cornell, s_c, key, pix, smp)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    tile_ref = render_tile(cornell, s_c, key, pix, smp)
    tile_eq = bool(torch.equal(tile, tile_ref))
    out["tile"] = dict(wall_s=wall_t, equal=tile_eq)
    print(f"[53 sharded render_tile] {n_t} pixels x {n_s} samples, depth "
          f"{s_c.max_depth}: wall {wall_t:.3f} s; equal to render_tile bit "
          f"for bit: "
          f"{tile_eq}", flush=True)
    if not tile_eq:
        raise AssertionError("sharded render_tile at one rank")

    # the train step: bench.py's fwd+bwd (2^18 lanes x 64 spp, 205
    # iterations, no schedule) with Adam, from the scene toward a target
    # rendered with the red wall's albedo moved by TRAIN["offset"]
    s_fb = s_c.replace(rr_depth=FWD_BWD["rr_depth"])
    n_l = FWD_BWD["lanes"]
    pix_fb = fwd_bwd_pixels(n_pix, n_l).to(dev)
    tex = cornell.textures
    red = int(torch.argmax(tex.c0[:, 0] - tex.c0[:, 1]))
    c0 = tex.c0.clone()
    c0[red] += TRAIN["offset"]
    moved = dataclasses.replace(cornell, textures=dataclasses.replace(
        tex, c0=c0))
    with torch.no_grad():
        target, _ = trace_wavefront_diff(moved, s_fb, key, pix_fb,
                                         FWD_BWD["spp"],
                                         n_iters=FWD_BWD["n_iters"])
    step = sharded_train_step_fn(
        mesh, s_fb, spp=FWD_BWD["spp"], n_iters=FWD_BWD["n_iters"],
        optimizer=lambda ps: torch.optim.Adam(ps, lr=TRAIN["lr"]))
    sc, state = cornell, step.init(cornell)
    losses, dists, walls = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iter_megakernel.launches = 0
    bounce_bwd_regen_pre_reduced.launches = 0
    bounce_bwd_regen_pre_megakernel.launches = 0
    for _ in range(TRAIN["steps"]):
        t0 = time.perf_counter()
        loss, sc, state = step.with_state(sc, state, key, pix_fb, None,
                                          target)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        dists.append(float((sc.textures.c0[red] - c0[red]).abs().sum()))
    l_b = iter_megakernel.launches
    l_k5 = bounce_bwd_regen_pre_reduced.launches
    l_k5_lane = bounce_bwd_regen_pre_megakernel.launches
    peak = torch.cuda.max_memory_allocated()
    d0 = float((cornell.textures.c0[red] - c0[red]).abs().sum())
    out["train"] = dict(losses=losses, albedo_dist=[d0] + dists,
                        walls_s=walls, launches_iter=l_b, launches_bwd=l_k5,
                        launches_bwd_per_lane=l_k5_lane, peak_bytes=peak,
                        primary_rays_per_s=n_l * FWD_BWD["spp"] / min(walls))
    print(f"[53 sharded train step] Adam lr {TRAIN['lr']}, {TRAIN['steps']} "
          f"steps of {n_l} lanes x {FWD_BWD['spp']} spp, "
          f"{FWD_BWD['n_iters']} iterations, no schedule: losses "
          f"{[round(x, 6) for x in losses]}, |red albedo - target's| "
          f"{[round(x, 4) for x in [d0] + dists]}, walls "
          f"{[round(x, 3) for x in walls]} s (best "
          f"{out['train']['primary_rays_per_s'] / 1e6:.3f} M primary rays/s)"
          f", launches B={l_b} K5 reduced={l_k5} K5 per lane={l_k5_lane}, "
          f"peak {peak / 2**30:.3f} GiB [{smi}]", flush=True)
    n_expect = TRAIN["steps"] * FWD_BWD["n_iters"]
    if (not np.isfinite(losses).all() or not losses[-1] < losses[0]
            or not dists[-1] < d0 or l_b != n_expect or l_k5 != n_expect
            or l_k5_lane):
        raise AssertionError("sharded train step: no descent or wrong "
                             "launches")
    loss_d, delta = dryrun_multichip(1, device=dev)
    out["dryrun"] = dict(loss=loss_d, param_delta=delta)
    dist.destroy_process_group()
    phase_done("M13 at one rank (NCCL)")

    # 54. two processes on cuda:0 over gloo (NCCL refuses two ranks on one
    # device): the gathered image and one train step's loss and gradients
    tr = TWO_RANKS
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        npz = os.path.join(tmp, "two.npz")
        port = free_port()
        cmds = [[sys.executable, "-m", "raytrace_tpu_torch.parallel.worker",
                 "--pid", str(pid), "--nproc", "2", "--port", str(port),
                 "--backend", "gloo", "--scene", "cornell", "--width",
                 str(tr["width"]), "--spp", str(tr["spp"]), "--depth",
                 str(tr["depth"]), "--train",
                 "--train-lanes", str(tr["train_lanes"])]
                + (["--out", npz] if pid == 0 else []) for pid in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, cwd=HERE, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, tr["timeout_s"] - (time.perf_counter()
                                                        - t0)))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall2 = time.perf_counter() - t0
        for pid, (p, log) in enumerate(zip(procs, logs)):
            print(f"[54 worker {pid}] exit {p.returncode}: "
                  f"{log.strip()[-1500:]}", flush=True)
        if any(p.returncode for p in procs):
            raise AssertionError("two processes over gloo: a worker failed")
        got = dict(np.load(npz))
    scene, s = cornell_scene_and_settings(tr["width"], tr["spp"],
                                          tr["depth"], device=dev)
    n2 = s.image_width * s.image_height
    key2 = rng.base_key(worker.SEED, dev)
    # each rank's block rendered in this process (a mesh of two ranks
    # without a process group gathers nothing): bit for bit, the blocks
    # being disjoint and gathered; the whole image at one rank: within
    # atol 2e-5, rtol 1e-5 (the rotation's lane maps follow the block's
    # lane count, so the samples of a pixel are summed in another order)
    blocks = [sharded_wavefront_render_fn(Mesh(2, 1, r), n2, tr["spp"])(
        scene, s, key2) for r in range(2)]
    same_blocks = (torch.cat(blocks)[:n2] / tr["spp"]).cpu().numpy(
    ).reshape(got["image"].shape)
    one = multihost.render(scene, s, seed=worker.SEED)
    bit_equal = bool(np.array_equal(got["image"], same_blocks))
    close = bool(np.allclose(got["image"], one, atol=2e-5, rtol=1e-5))
    n_diff = int((got["image"] != one).any(-1).sum())
    step1 = sharded_train_step_fn(make_mesh(), s)
    lanes = (torch.arange(tr["train_lanes"]) % n2).to(torch.int32)
    loss1, grads1 = step1.loss_and_grads(
        scene, key2, lanes, torch.arange(tr["spp"]),
        torch.zeros((tr["train_lanes"], 3)))
    g1 = {k: v.cpu().numpy() for k, v in leaves(grads1).items()}
    loss_rel = abs(float(got["loss"]) - float(loss1)) / abs(float(loss1))
    worst = max(float(np.abs(got[f"grad/{k}"] - v).max())
                / max(float(np.abs(v).max()), 1e-30) for k, v in g1.items())
    out["two_ranks"] = dict(wall_s=wall2, image_bit_equal=bit_equal,
                            image_close_to_one_rank=close,
                            pixels_differing_from_one_rank=n_diff,
                            loss=float(got["loss"]),
                            loss_one_rank=float(loss1),
                            loss_rel=loss_rel, grad_worst=worst)
    print(f"[54 two processes, gloo on cuda:0] cornell {s.image_width} x "
          f"{s.image_height}, {tr['spp']} spp, depth {tr['depth']}: wall "
          f"{wall2:.1f} s (two process starts included); image equal bit for "
          f"bit to the same two blocks in one process: {bit_equal}; to the "
          f"one-rank image within atol 2e-5, rtol 1e-5: {close} "
          f"({n_diff} of {n2} pixels not bit-equal); train step over "
          f"{tr['train_lanes']} lanes: loss {float(got['loss']):.6f} against"
          f" {float(loss1):.6f} at one rank (rel {loss_rel:.3g}), worst leaf "
          f"max|diff|/max|one rank| {worst:.3g} (bound {GRAD_RTOL}) "
          f"[{smi}]", flush=True)
    if not (bit_equal and close and loss_rel <= GRAD_RTOL
            and worst <= GRAD_RTOL):
        raise AssertionError("two processes over gloo disagree with one")
    phase_done("two processes (gloo)")
    return dict(summary=out,
                a_launches=l_wave.get("A", 0),
                b_launches=l_b, k5_launches=l_k5)


# phase 55's runs: the pawn stand-in's samples per pixel, the queue's
# lanes
STATS = dict(pawn_spp=2, queue_lanes=1 << 16)


def _stats_phases(smi, phase_done, dev) -> dict:
    """Phase 55: the forward drivers' ``with_stats`` on the card, one run
    of each branch, held to the launch counters and to the run without
    the flag."""
    import torch
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.render.integrator import (
        trace_wavefront, trace_wavefront_sorted, trace_wavefront_stationary,
    )
    from raytrace_tpu_torch.testing import (
        cornell_scene_and_settings, pawn_standin_scene,
    )
    reset, read = _launch_counters()
    cornell, s_c = cornell_scene_and_settings(600, 8, 50, device=dev)
    pawn, s_p = pawn_standin_scene(500, STATS["pawn_spp"], 20, device=dev)
    n_c = s_c.image_width * s_c.image_height
    n_p = s_p.image_width * s_p.image_height
    key = rng.base_key(7, dev)
    spp_p, q_lanes = STATS["pawn_spp"], STATS["queue_lanes"]
    # (label, the route's per-iteration kernels, pixels, spp, the call)
    runs = (
        ("cornell 600 x 600, 8 spp, rotate_k 8", ("B",), n_c, 8,
         lambda **kw: trace_wavefront_stationary(cornell, s_c, key, n_c, 8,
                                                 rotate_k=8, **kw)),
        ("cornell 600 x 600, 1 spp (fused)", ("B",), n_c, 1,
         lambda **kw: trace_wavefront_stationary(cornell, s_c, key, n_c, 1,
                                                 **kw)),
        (f"pawn stand-in 500 x 500, {spp_p} spp (sorted)", ("K9", "K11b"),
         n_p, spp_p,
         lambda **kw: trace_wavefront_sorted(pawn, s_p, key, n_p, spp_p,
                                             **kw)),
        (f"cornell 600 x 600, 1 spp, queue of {q_lanes} lanes", ("A",), n_c,
         1, lambda **kw: trace_wavefront(cornell, s_c, key, n_c, 1, q_lanes,
                                         **kw)),
    )
    out, total = {}, {}
    for label, kernels, n_pix, spp, call in runs:
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        acc, st = call(with_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read()
        equal = bool(torch.equal(acc, call()))
        for k, v in read().items():
            total[k] = total.get(k, 0) + v
        it, seg, lanes = st["iterations"], int(st["segments"]), st["lanes"]
        occ = seg / (it * lanes)
        out[label] = dict(iterations=it, segments=seg, lanes=lanes,
                          occupancy=occ, wall_s=wall,
                          ms_per_iteration=wall * 1e3 / it,
                          launches={k: got[k] for k in kernels},
                          bit_equal=equal)
        print(f"[55 stats] {label}: {it} iterations, {seg} segments, "
              f"{lanes} lanes, occupancy {occ:.4f}, wall {wall:.3f} s "
              f"({wall * 1e3 / it:.4f} ms an iteration), launches "
              f"{out[label]['launches']}, image bit-equal without the flag: "
              f"{equal} [{smi}]", flush=True)
        if not (equal and all(got[k] == it for k in kernels)
                and lanes * it >= seg >= n_pix * spp):
            raise AssertionError(f"driver stats of {label}")
    print("[55 stats] occupancies " + json.dumps(
        {k: round(v["occupancy"], 4) for k, v in out.items()}), flush=True)
    phase_done("driver stats")
    return dict(summary=out, launches=total)


# the sorted driver's turn at pawn-fwd's shapes: the image, samples a pixel
# of the checked render and of the timed renders, the turn whose HEAD and
# TAIL are timed, and the float and integer operations a lane counted from
# csrc/sorted_turn.cu (HEAD: ceil(N / 2) avalanches of ~12, the keys ~10,
# the camera ~60; TAIL: the cap, roulette and key ~40)
SORTED = dict(width=500, checked_spp=2, timed_spp=4, turn=8, head_ops=170,
              tail_ops=40)


def _sorted_turn_phases(smi, phase_done, dev) -> dict:
    """Phase 56: the sorted driver's HEAD and TAIL (csrc/sorted_turn.cu)
    at pawn-fwd's shapes: every launch of a checked render against the
    plain versions, the two kernels' times beside their bounds on a
    middle turn, the host launches a turn and the ms a turn against the
    plain versions'."""
    import torch
    from torch.autograd import DeviceType
    from portbench.trace import LAUNCH_CALLS
    from raytrace_tpu_torch.core import rng
    from raytrace_tpu_torch.ops import sorted_turn as sturn
    from raytrace_tpu_torch.render import integrator
    from raytrace_tpu_torch.testing import (
        pawn_standin_scene, plain_sorted_turn, sorted_turn_checks,
    )
    w = SORTED["width"]
    pawn, s_p = pawn_standin_scene(w, SORTED["checked_spp"], 20, device=dev)
    n_pix = w * w
    key = rng.base_key(24, dev)
    kernels = (integrator.sorted_head, integrator.sorted_tail)

    # 56a. every launch of a 2-spp render against the plain versions
    stats = {}
    checks = sorted_turn_checks(stats, *kernels)
    integrator.sorted_head = checks["sorted_head"]
    integrator.sorted_tail = checks["sorted_tail"]
    try:
        acc, st = integrator.trace_wavefront_sorted(
            pawn, s_p, key, n_pix, SORTED["checked_spp"], with_stats=True)
    finally:
        integrator.sorted_head, integrator.sorted_tail = kernels
    head, tail = stats["sorted_head"], stats["sorted_tail"]
    lanes = st["lanes"]
    print(f"[56 HEAD vs plain] pawn stand-in {w}x{w}, "
          f"{SORTED['checked_spp']} spp, {lanes} lanes, "
          f"{head['launches']} launches: {head['n_int']} exact entries "
          f"differing, max |err| {head['err']}, turns {head['turns']} "
          f"[{smi}]", flush=True)
    print(f"[56 TAIL vs plain] {tail['launches']} launches: "
          f"{tail['n_int']} exact entries differing, max |err| "
          f"{tail['err']}, radiance sums' worst excess "
          f"{tail['acc_excess']:.3e}", flush=True)
    if not (head["launches"] == tail["launches"] == st["iterations"] > 0
            and head["n_int"] == tail["n_int"] == 0
            and head["err"] == tail["err"] == 0.0
            and tail["acc_excess"] <= 0.0
            and all(head["turns"].values())
            and bool(torch.isfinite(acc).all())):
        raise AssertionError("56: HEAD or TAIL differs from its plain "
                             "version")
    phase_done("sorted turn checked")

    # 56b. HEAD and TAIL of a middle turn, captured and launched alone
    cap = {}

    def head_spy(turn, perm, lanes_, par):
        out = kernels[0](turn, perm, lanes_, par)
        if sturn.sorted_head.launches == cap.get("at"):
            cap["head"] = (turn, perm.clone(), sturn.SortedLanes(
                *(x.clone() for x in (lanes_.fstate, lanes_.istate,
                                      lanes_.key, lanes_.ctl))), par)
        return out

    def tail_spy(turn, lanes_, par, hd, out, acc3, segments=None):
        if "head" in cap and "out" not in cap:
            cap["out"] = tuple(x.clone() for x in out)
            cap["n_pix"] = acc3.shape[1]
        return kernels[1](turn, lanes_, par, hd, out, acc3, segments)

    cap["at"] = sturn.sorted_head.launches + SORTED["turn"]
    integrator.sorted_head, integrator.sorted_tail = head_spy, tail_spy
    try:
        integrator.trace_wavefront_sorted(pawn, s_p, key, n_pix,
                                          SORTED["timed_spp"])
    finally:
        integrator.sorted_head, integrator.sorted_tail = kernels
    turn, perm, lanes_h, par = cap["head"]
    out = cap["out"]
    lanes_t = sturn.SortedLanes(*(x.clone() for x in (
        lanes_h.fstate, lanes_h.istate, lanes_h.key, lanes_h.ctl)))
    acc3 = torch.zeros((3, cap["n_pix"]), device=dev)
    head_fn = lambda: sturn.sorted_head(turn, perm, lanes_h, par)
    hd = head_fn()
    alive_in = hd[5].clone()
    tail_fn = lambda: sturn.sorted_tail(turn, lanes_t, par, hd, out, acc3)
    tail_fn()
    died = int((alive_in & ~(lanes_t.istate[3] > 0)).sum())
    n_cols = turn.n_u + 6
    r = turn.lanes
    head_bytes = r * (8 + 13 * 4 + 4 * 4 + 13 * 4 + 4 * n_cols + 3 * 4 + 1)
    tail_bytes = r * (13 * 4 + 2 + 3 * 4 + 4 + 13 * 4 + 4 * 4 + 4) \
        + died * 3 * 4
    kt = {}
    for name, fn, n_bytes, ops in (
            ("HEAD", head_fn, head_bytes, SORTED["head_ops"]),
            ("TAIL", tail_fn, tail_bytes, SORTED["tail_ops"])):
        kname = "sorted_head_kernel" if name == "HEAD" \
            else "sorted_tail_kernel"
        ms = _device_ms(fn, kname, 50)
        host = _time_ms(fn, 50)
        bound = _bound_ms(n_bytes, ops * r)
        kt[name] = dict(ms=ms, host_ms=host, bound_ms=bound[0],
                        bound_by=bound[1], bytes=n_bytes)
        print(f"[56 time] {name} on turn {SORTED['turn']} of the pawn "
              f"stand-in {w}x{w} ({r} lanes, {n_cols} uniform columns, "
              f"{died} paths finished): {ms:.4f} ms device, {host:.4f} ms "
              f"a call back to back, bound {bound[0]:.4f} ms "
              f"({bound[1]}: {n_bytes / 1e6:.2f} MB), "
              f"{100 * bound[0] / ms:.1f}% of it [{smi}]", flush=True)
    phase_done("sorted turn times")

    # 56c. host launches and ms a turn, HEAD and TAIL against their plain
    # versions (the driver's torch lines), in turns
    run = lambda: integrator.trace_wavefront_sorted(
        pawn, s_p, key, n_pix, SORTED["timed_spp"])

    def profiled():
        before = sturn.sorted_head.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        calls = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CPU
                    and e.name in LAUNCH_CALLS)
        return calls, sturn.sorted_head.launches - before

    def timed():
        torch.cuda.synchronize()
        before = sturn.sorted_head.launches
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sturn.sorted_head.launches - before

    calls, turns = profiled()
    with plain_sorted_turn():
        plain_calls, _ = profiled()
    walls = {"kernels": [], "plain": []}
    for _ in range(2):
        walls["kernels"].append(timed()[0])
        with plain_sorted_turn():
            walls["plain"].append(timed()[0])
    ms_turn = {k: [1e3 * v / turns for v in vs] for k, vs in walls.items()}
    rays = n_pix * SORTED["timed_spp"]
    print(f"[56 launches] a sorted turn of the pawn stand-in {w}x{w}, "
          f"{SORTED['timed_spp']} spp ({turns} turns): "
          f"{calls / turns:.2f} host launches (plain versions: "
          f"{plain_calls / turns:.2f}) [{smi}]", flush=True)
    print(f"[56 turn] ms a turn in turns, HEAD and TAIL "
          f"{[round(v, 4) for v in ms_turn['kernels']]}, plain versions "
          f"{[round(v, 4) for v in ms_turn['plain']]}; M primary rays/s "
          f"{[round(rays / v / 1e6, 3) for v in walls['kernels']]} against "
          f"{[round(rays / v / 1e6, 3) for v in walls['plain']]} [{smi}]",
          flush=True)
    if calls / turns > 80:
        raise AssertionError(f"56: {calls / turns:.1f} host launches a "
                             f"sorted turn (at most 80)")
    phase_done("sorted turn launches")
    return dict(summary=dict(checked=dict(head=head, tail=tail),
                             kernels=kt, launches_a_turn=calls / turns,
                             plain_launches_a_turn=plain_calls / turns,
                             ms_a_turn=ms_turn, turns=turns))


if __name__ == "__main__":
    main()
