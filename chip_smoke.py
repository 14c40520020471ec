"""Drive the PyTorch/CUDA port on one GPU and check it: the flagship render,
the staged render, the inverse-rendering (training) step, the AB3 march,
the certified (critical-band refined) render, the full-featured render
(jets, start jitter, the NRS far field, the shadow overlay), the float64
oracle's gates, the central-difference inverse path, NRS training, the
progressive tile renderer, temporal accumulation, the engine facade, the
app in front of them (the CLI, the live loop, the cinematic director
and the checkpointed inverse path), the multi-device layer (the
sharded render and steps over ``torch.distributed``, ``cli sweep``), the
differentiable render (``render_radiance`` under autograd), and the float64
render (the march and gradient kernels' float64 instantiations) with the
sharded render under autograd.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result line:

1. Build: compile every CUDA source (``render.cu``, ``march.cu``,
   ``march_grad.cu``, ``vpu_peak.cu``, ``step_vjp_check.cu``,
   ``tonemap.cu``) with nvcc
   (one process per source, started together; every march kernel is
   instantiated for both routes, exact and approx_recip) and print the
   build seconds, ptxas's registers and spills of each kernel, and the
   gradient kernel's dynamic shared memory per block (its re-forward
   stack; in float64 the reverse kernel's tape) and the float64 kernels'
   warps per SM. A copy of ``march_grad.cu`` that counts the float64
   reverse kernel's busy lanes (``tools/grad_census.py::count_lanes``,
   built under ``build/grad_census/``) and a copy of ``march.cu`` that
   counts the march kernel's step loop's busy lanes
   (``tools/march_census.py::count_lanes``, under ``build/march_census/``)
   build beside them. Then the FP32
   peak: the probe
   (``tools/vpu_peak.py``) at its measuring size, whose output is held
   against its plain version on the same starts (which rounds each step once
   as the kernel's FMA does: rel < 1e-6, where one missing loop iteration
   moves a chain by ~1.4e-6), and its measured lane-FMA rate, beside the
   published 67 TFLOP/s. Every ``bound_ms`` below is the larger of the
   hand-counted operations over the larger of the measured rate and the
   published one in lane FMAs (33.5e12/s; each counted add or multiply is
   one lane instruction under ``--fmad=false``, and on the approx_recip
   route each contracted multiply-add one, ``OPS_PER_STEP*_FUSED``, so the
   bound never flatters a kernel) and the bytes over 3.35 TB/s.
2. Short-horizon parity: the render kernel against its plain PyTorch version
   (``ops/render.py::render_planes``) on the card, exact divides, 48 steps,
   a = 0.9, 250x141 (neither side a multiple of the kernel's block), for the
   spectral and the analytic disk: p99 |d| < 1e-4 and mean |d| < 1e-5.
3. The approx_recip route at 480x270, 256 steps (approximate reciprocals
   and contracted multiply-adds in the kernel; the plain version divides
   exactly and rounds every operation): all finite, mean |d| < 1e-3, fewer
   than 1% of pixels with |d| > 1e-2 (the chaotic critical-band rays), for
   the render kernel's flagship, AB3, jets and full-featured
   instantiations, the march kernel's midpoint and AB3 ones (staged
   renders, the plain march in place of the kernel) and its jets one (the
   jets' radiance rows).
4. The main path: ``render()`` at 1920x1080 on the flagship scene (Kerr
   a = 0.999, spectral disk, 256 steps, the ``bench.py`` / ``cli render``
   MarchConfig). The launch counter is reset just before and read just
   after; CUDA-event median ms/frame over the timed frames and Mrays/s. The
   kernel alone and one frame of the plain version are timed on the same
   inputs, and the kernel is held against the plain version there too.
   Every frame launches the tone-map kernel once (``tonemap_kernel``
   counts them). On the frame's radiance the tone-map kernel alone, on
   the render's planar view and on a contiguous copy, in float32 and
   float64, each bit-equal to ``tonemap_plain``, beside the plain path's
   time, its bound, registers, spill, shared memory and warps per SM.
5. The march kernel (``csrc/march.cu``) against its plain version
   (``ops/pallas_march.py::march_u_plain``) on camera rays at 250x141
   (not a multiple of a warp), 48 steps, exact divides, a = 0.9: identical
   hit, steps and crossing counts, |d| < 1e-4 on states and records. Then
   the staged render (the flagship config with ``fused=False``, through
   the march kernel; its launch counter reset before and read after)
   against the fused render at 480x270: p99 |d| < 1e-4 analytic and
   < 2e-2 spectral (tests/test_fused.py's bars); mean |d| < 5e-5 over all
   pixels, and < 1e-5 (that file's mean bar) over the pixels with
   |d| <= 1e-2. It prints the share of pixels above 1e-2. Last, a staged
   spectral scene from ``Scene.create`` (no Chebyshev tables, so its disk
   shades from the LUTs, as the JAX package's does) at 96x54, 48 steps,
   exact divides, on the card against its plain render on the CPU: p99
   |d| < 1e-4, mean < 1e-5, and its second frame finds the tables cached
   on the card.
6. The gradient kernel (``csrc/march_grad.cu``) on tests/test_grad_kernel.py's
   scene (48x32 rays, 48 steps, exact divides) and loss: d/d(spin) through
   ``march_rows_ad`` (both kernels) against autograd straight through the
   plain march on the card, rel < 5e-3 at a = 0.3 and 0.9; d/d(mass)
   rel < 2e-2; per-ray cotangents 95th-percentile rel < 1e-2; with
   ``cotangent_clip = 0.05`` rel < 2e-2 and unlike the unclipped gradient;
   all finite.
7. The training path at full width: ``make_inverse_step`` at 1920x1080 in
   bench.py's configuration (flagship camera and MarchConfig with
   ``fused=False``, analytic disk, spin 0.9, zero target). Both launch
   counters are reset just before the timed steps and read just after; the
   CUDA-event median ms/step and fwd+bwd Mrays/s; loss, parameters and
   Adam moments finite. On the arguments the kernels received in one real
   step (``march_u.record``, ``march_grad_kernel.record``), each kernel is
   timed alone and held against its plain version at exact divides: the
   march's integers equal and its floats within 1e-4 on all but 0.1% of
   rays; the gradient's initial-row cotangents p95 rel < 1e-2, each ray's
   worst row p99.9 rel < 2e-3 and above 1e-3 on under 0.2% of rays, and
   all four summed partials (m, a, r_h, r_ph) rel < 1e-3. Then
   ``ad_inverse_render`` at 256x256 (target at a = 0.85, start at 0.5,
   stages ((64, 8), (96, 4)), 36 steps): the final loss below 0.1x the
   first and |spin - 0.85| < 1e-2. Also the gradient kernel's per-step
   check (``csrc/step_vjp_check.cu``): its hand-written adjoint against the
   forward-mode ``Dual<11>`` pass over the same step, on 65,536 of the
   recorded step's rays (a seeded sample) at every live step, with seeded
   unit cotangents, approx_recip on and off: the relative difference
   (floored as the gradient's) p99 <= 1e-4 and above 1e-3 on at most 0.1%
   of elements, every element within 1e-4 of the size of its derivative's
   terms (a ``Mag<11>`` pass: the sum of their absolute values), all
   finite; both routes against float64 autograd through the plain step,
   reported with the worst elements. The renormalization's VJP alone at
   planted radial turning points (discriminants of exactly 0 among them):
   adjoint against ``Dual<7>``, each state within 1e-5 of its largest
   cotangent, and the exact double root against float64 autograd. The
   CPU mirror ``ops/march_adjoint.py`` against the header on 4,096 of the
   step's rays at every live step, exact divides: bit-equal. And the
   kernel's resident warps per SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through ctypes on
   the built library), registers, spills and shared memory. And the
   gradient kernel's replay against the forward march on the recorded
   step's rays (approx_recip on): every ray's hit, live steps and crossing
   count equal the march kernel's.
8. The AB3 march (``multistep``): the march kernel against
   ``march_u_plain`` at 250x141, 48 steps, exact divides, a = 0.9 (integers
   identical, |d| < 1e-4); the render kernel against ``render_planes`` there,
   analytic and spectral (p99 < 1e-4, mean < 1e-5); tests/test_ab3.py's
   structural bars against the midpoint render at 480x270, 96 steps
   (median |d| < 5e-3, more than 95% of pixels with |d| < 0.3); the
   flagship ``render()`` at 1920x1080 with ``multistep`` (median of 30
   CUDA-event frames, the kernel alone, steps per ray, beside phase 4's
   midpoint numbers) and the staged AB3 render there, whose march kernel is
   timed alone on its recorded arguments.
9. The certified render (``refine_band=0.6, refine_budget=16384``, as
   ``bench.py:195-196``): the band plane against ``render_planes`` and
   against ``critical_band_metric_u`` on the same rays at 250x141, a = 0.999
   (max |d| < 1e-3, 0 < share below 0.6 < 0.05); ``render()`` at 1920x1080
   on the flagship scene (median of 30 CUDA-event frames, the render and
   march kernels once per frame, the band's pixel count and overflow, the
   refinement pass alone and its re-march kernel alone with its steps);
   band agreement, the port's twin of ``tools/band_agreement.py:64-79``
   (hit classes of the production, refined and fine-reference marches over
   the band, ``agree_band_refined`` >= 0.99, ``bench.py:226-228``), whose
   refined pixels are the ones ``select_band`` picks from the 1080p render
   kernel's band plane, as the certified render picks them; and
   the staged-refined against the fused-refined render at 480x270
   (test_fused.py:188-196's config, p99 |d| < 1e-3).
10. The full-featured render. (a) The render kernel against
   ``render_planes`` at 250x141, 48 steps, exact divides, a = 0.9, for
   each new branch alone (jets, ``start_jitter=0.5``, the NRS far field at
   fov 1.0 with the port's seeded ``nrs_init(0)`` weights, the shadow
   overlay) and all four together: p99 |d| < 1e-4, mean < 1e-5, the max
   printed (bit-equal is the aim). (b) The march kernel's jets
   instantiation against ``march_u_plain`` there: integers identical,
   states and records |d| < 1e-4, jet rows rel < 1e-5. (c) The staged
   against the fused render for each feature at 480x270 (the flagship
   MarchConfig at exact divides; the overlay through ``render()``, the
   staged branch drawing it there): p99 |d| < 1e-4, mean < 5e-5.
   (d) ``render()`` at 1920x1080 of ``scene_from_params(SimulationParams(
   enable_jets=True), 1920, 1080)`` (the ``cli render --set enable_jets=1``
   scene): median of 30 CUDA-event frames with min and max, the kernel
   alone, its steps, registers and spills, and the bound with the jets'
   operations; then the same for the full-featured 1080p scene (jets,
   ``start_jitter=0.5``, the overlay and the NRS far field, at fov 1.2 so
   that rays lie beyond b_min), and the staged jets render at 1080p, whose
   march kernel (jets instantiation) is timed alone on its recorded
   arguments. (e) The flagship instantiations keep their registers
   (``FLAGSHIP_REGISTERS``), phase 4's kernel stays within 5% of the
   certified render's slice's spread and its frame within 1.25x of it (the
   frame is mostly host work and tonemap, which vary with the host the card
   shares). Each 1080p render path's kernel and the staged AB3 march stay
   within 5% of their times after the step's redesign (``PARENT_KERNEL_MS``,
   the step-redesign slice's own times; before it, the gate held the
   persistent march kernel's commit's times).
11. Small and ragged launches: the render kernel (midpoint, AB3, every
   branch with jets) at 1x1, 31x1, 128x128 and 250x141 and the march
   kernel (midpoint, AB3, jets) on 1, 31, 16,384 (fewer than its resident
   lanes) and 35,250 rays, each against its plain version at 48 steps and
   exact divides (step counts identical, hit and crossing counts too for
   the march, the floats at phases 2 and 5's bars); and each launch's
   outputs all written: two launches into buffers pre-filled with
   different sentinels agree bit for bit, and the march kernel's ray pool
   is back at zero after each.
12. What holds the two forward kernels back on each 1080p path: its lane
   efficiency (its step counts grouped into warps as a one-ray-per-thread
   launch groups them: the render kernel's 8 x 4 patches,
   ``ops/render.py::launch_pixel_order``; 32 consecutive rays for the
   march), the uniform-ray probe (the march kernel on 2,073,600 copies of
   one ray of the path's march, one near the median step count and one of
   the longest: ms / (steps x rays) is what a ray-step costs at full
   occupancy, and that cost x the path's steps its time without
   divergence; its twin for the render kernel is a 1080p frame at fov 1e-7
   whose pixels all march the view axis, midpoint against AB3 on both
   routes), and the refinement re-march's critical path (its longest
   ray alone, and 32 copies of it). Each render entry of the kernels line
   carries ``lane_efficiency`` (its own launch's warps) and each march
   entry ``lane_efficiency_one_per_thread`` (warps of 32 consecutive rays,
   the launch the persistent loop replaced); both carry
   ``resident_warps_per_sm`` (the occupancy API on the built library), the
   refinement's ``critical_path_ms``. Every instantiation of both kernels
   is printed with its registers, spills and resident warps per SM; a
   spill fails.
13. The step's instructions: ``tools/sass_census.py`` on this run's
   libraries (the march loop of every instantiation by instruction class,
   printed on a ``census`` line, its FP32 arithmetic beside the counted
   operations per step); march_step.cuh's one-instruction ``jmax`` /
   ``jmin`` against the compare-compare-select form they replaced on
   planted pairs (signed zeros, NaN, infinities, denormals: the same bits
   or both NaN, but for the ties of opposite-sign zeros, which are
   printed); and no render or march entry above 100% of its bound.
14. The oracle gates on the card (the float64 adaptive-RKF45 oracle,
   ``geodesic/oracle.py``, on ``cuda``; its trials in blocks of 32, each
   block one captured CUDA graph), on tests/test_oracle_gate.py's scene
   (no star spots): (a) the oracle on the card against the same oracle on
   the CPU, the one CPU run of the phase and named as the reference, at
   24x16, a = 0.999, disk on: hit codes identical on >= 99% of rays, image
   p99 |d| < 1e-6; (b) ``bench.py:336-389``'s gate_full at 256x256,
   a = 0.999 (the oracle there also run without graphs: bit-equal, both
   timed): the fast render at the validation step (step_rate 0.03, 1024
   steps) on the staged route (march kernel) and the fused one (render
   kernel), each frac_ok > 0.98 and trimmed_rel < 1e-2; (c)
   ``bench.py:391-466``'s gate_1080p: the certified flagship frame
   (approx_recip, refine_band 0.6, analytic shading) at 4096 stratified
   pixels (seed 0) against the oracle through ``camera_rays_indexed`` in
   float64: frac_ok > 0.98, abs_err_p99 < 1e-2, rel_err_bright_median
   < 0.05; (d) the convergence ladder (test_oracle_gate.py:105-155)
   through ``march`` (the march kernel) at a = 0, 48x32: median escape
   angle < 2e-2 at step rate 0.2, each halving < 0.55x the rung before,
   < 1.5e-3 at 0.05; (e) the gradient gates (test_oracle_gate.py:236-380)
   at 48x32, a = 0.999, turbulence 0, the validation step: d/d(spin) and
   d/d(theta_cam) through ``parallel/train.py::_forward`` (the march and
   gradient kernels), d/d(density) through ``render_sample_scaled``, each
   against the card's oracle central difference at two step sizes: stable
   share > 0.7, the same sign, rel < 0.2. Each part prints its seconds.
15. The central-difference inverse path: ``make_fd_inverse_step`` at
   1920x1080 in phase 7's configuration (5 timed steps after a warm-up, the
   march kernel's counter reset before them; CUDA-event median ms/step and
   Mrays/s over the nine forward passes; exactly nine march launches per
   step; loss and state finite), then ``inverse_render(method="fd")`` in
   tests/test_parallel.py:155-176's configuration (64x64, target a = 0.85,
   160 steps, start 0.55, lr 0.04, 48 steps): final loss < 0.2x the first,
   |spin - 0.85| < 0.02, nine launches per step.
16. NRS training at full size (tests/test_models.py:73-74):
   ``generate_training_data(n=384, seed=1)`` on the card (seconds with
   the integrator's trial blocks as CUDA graphs and eager, bit-equal; the
   trials; the launches per trial and idle share of one eager 32-trial
   block under torch.profiler) against the same call on the CPU, the
   phase's one CPU reference: the inputs equal, the escape flags
   identical, deflection and delay |d| < 1e-5; ``train_nrs(x, y,
   n_steps=2500, lr=5e-3)`` on the card (ms per step, launches per step):
   final loss < 0.01; 400 steps on the card and on the CPU from the same
   weights: loss histories within rel 1e-3; the trained surrogate's far
   field at 1920x1080 in tests/test_models.py:86-112's scene (r = 60,
   theta = pi/2 - 0.2, fov 1.0, a = 0.6, the march through the march
   kernel at 512 steps, escape radius 300, far cap 0.4): the median angle
   error < 2 deg and < 0.25x the straight line's; the render kernel's NRS
   branch on the trained weights at 250x141 against ``render_planes``
   (phase 2's bars), and at 1920x1080 (30 CUDA-event frames, the kernel
   alone beside phase 10's full-featured kernel, a kernels-line entry).
17. The progressive tile renderer (``render/tiles.py``) at 1920x1080 on
   the flagship scene with ``fused=False``, tile 64, batch 8: every pixel
   covered, one march launch per batch (64 per frame), the image against
   the staged ``render_radiance``: (|d| < 1e-3) on more than 99.8% of the
   pixels (tests/test_tiles.py:79), the bit-equal share and the max |d|
   printed; two frames' CUDA-event ms beside ``render_radiance``'s, the
   device idle share and launches of one batch under the profiler; one
   tile batch's march kernel alone on its recorded arguments and its exact
   route against the plain march (a kernels-line entry).
18. Temporal accumulation at 1920x1080: 16 flagship frames at
   ``halton_jitters`` offsets through ``TemporalAccumulator.resolve`` on
   the card, and the same frames copied to the CPU through the CPU's
   accumulator: max |d| < 1e-5; then 8 frames of an orbit (phi += 0.01
   per frame, ``camera=`` passed, so ``taa_resolve_reprojected``) under
   the same bar; the CUDA-event ms and the launches of each resolve.
19. ``PhysicsEngine`` on the card against ``PhysicsEngine(device="cpu")``
   in float64: the scalar API (horizon, ISCO, photon sphere, dilation,
   Hawking temperature, disk flux at mdot 2.5, g-factor, shadow radius and
   shift) rel < 1e-12; the disk and spectrum LUTs and both meshes rel <
   1e-10; the Kretschmann, frame-drag and light-cone fields at ``cli
   fields``' defaults and on a 1024x1024 grid (timed) rel < 1e-10; one
   ``tick`` of the native bridge (which must load; ``native/`` left
   untouched); one ``integrate_ray_relativistic`` with the same
   termination and steps on both devices.
20. The app on the card, through ``app.cli.main`` (no ``--device``: the
   card by default) and ``app.live.run_live``, outputs in a temporary
   directory: ``render`` at 1920x1080 (the CLI's default parameters, the
   fused path; its PNG equal byte for byte to ``encode_png`` of the
   direct ``render(scene_from_params(...)).clamp(0, 1)`` on the card),
   then ``--certified``, each's wall seconds (PNG encode included) and
   launches; ``animate --director grand_survey --frames 8`` at 480x270 (8
   render launches, each PNG equal to the direct render of
   ``grand_survey(i / 30)``'s camera); ``run_live`` headless at 1280x720,
   240 frames of the orbit script with the calibration (frames, FPS mean
   and p5, quality, calibrated FPS, final scale, scale changes), then 48
   frames without it under the profiler (render launches per displayed
   frame, 1 expected; the device idle share); the display program
   (antialiased resize to 66x120, reprojected TAA, uint8) on the card
   against the CPU on the same card-rendered 1280x704 frames (max |d| <=
   1e-5 before the cast) and the render kernel alone at that rung (a
   kernels-line entry); ``inverse`` at its defaults (96x96, 60 AD steps:
   seconds and march and gradient launches per step, |recovered - true|,
   finite JSON); ``inverse --checkpoint-dir --steps 10`` stopped after
   the save of step 6 and resumed by a fresh ``main`` against an
   uninterrupted run (the final FD state bit for bit); ``bench`` and
   ``validate`` with ``--seconds 1`` at 480x270 (finite FPS, frames > 0);
   ``info`` and ``fields`` on the card against ``--device cpu`` (rel <=
   1e-12 / 1e-10).
21. The multi-device layer (``parallel/mesh.py``, ``parallel/render.py``,
   the mesh branches of ``parallel/train.py``, ``cli sweep``). (a) World 1
   on NCCL in this process (file init), so the collectives run on the
   card: ``render_sharded`` of the flagship scene (spectral disk, a =
   0.999, 256 steps, ``use_pallas``; the sharded path takes the staged
   march kernel) and of phase 10's jets scene at 1920x1080, each
   bit-equal to the single-device ``render()`` of ``single_device_twin``
   (fused off, no refinement, overlay or NRS skip; for jets also no jets
   and no precull, as the sharded render marches them: JAX
   parallel/render.py:66-81 gives march_rows no jets), one march launch
   and no render launch per frame; 5 CUDA-event frames of each (the
   sharded and the single-device render), one profiled frame, and the
   march kernel alone. (b) Gloo worlds of 2 and 3 spawned processes
   sharing the card (NCCL refuses two ranks on one device): each rank's
   image bit-equal to world 1's, one march launch per rank per frame; at
   world 3 the frame is 1922x1078, whose 527 pixel blocks leave 4,096
   zero rays (r = 0) in the last shard in block order and one in
   row-major order (1918x1078's 510 blocks split evenly): the kernel's hit,
   steps and crossing count equal the plain version's on every padding
   ray, all dead at step 0. (c) The sharded AD step (``make_inverse_step``)
   and FD step on phase 7's training scene at 1080p, world 2 against world
   1: loss rel < 1e-4, spin |d| < 5e-5, FD loss rel < 1e-4 and state
   vector |d| < 5e-4 (tests/test_parallel.py's bars), one march and one
   gradient launch per rank per AD step, nine march launches per rank per
   FD step; the world-1 step timed. (d) ``cli sweep`` at its defaults but
   ``--frames 4`` (480x270, grand_survey, one sample) on the world-1 mesh:
   the npz frames bit-equal to ``render_sharded`` of the director's
   cameras, ``devices: 1``, one march launch per frame. Kernels-line
   entries: the march kernel on world 1's flagship and jets launches,
   rank 0's flagship shard and AD-step shard at world 2 and the sweep's
   first frame (each against its plain version at exact divides, phase
   17's bars), and the gradient kernel on rank 0's AD-step shard (phase
   7's bars).
22. The differentiable render. (a) The gradient kernel's jets
   instantiation against its plain version (``march_grad`` with the
   jets) on the 64x64 crop of phase 10's 1080p jets scene where the jets
   are, on the AD route (the exact midpoint march, no precull), with the
   cotangents of the crop's mean radiance (recorded from ``march_rows``
   and the composite under autograd): phase 7's bars. (b) ``render_radiance``
   under autograd at 1920x1080: the flagship physics (a = 0.999, r = 30,
   spectral disk on the LUT route, 256 steps) on the staged route
   (``use_pallas=False``), and the same with the jets; the scene's seven
   leaves (mass, spin, the camera's r, theta, phi, fov, roll) as 0-d
   tensors that require grad; the mean radiance's gradient in each,
   finite; forward + backward and the forward alone, median of 5; the
   march and gradient launches per frame (one each); the gradient kernel
   alone on the frame's recorded arguments, its bound and its
   instantiation's registers and spill; the flagship frame's gradient
   kernel against its plain version (phase 7's bars). (c) The oracle
   gradient gates for spin and theta through ``render_radiance``, as the
   JAX package's tests/test_oracle_gate.py:236-304 and :362-395 run them
   (phase 14's ``param_gate`` and oracle frames). (d) Eight crossings: the
   march, render and gradient kernels' KMAX = 8 builds, each against its
   plain version on near-critical rays (a 64x64 pixel at sub-pixel
   offsets about its critical point) that record up to 6 crossings: the
   march and render bit-equal (exact route), the gradient at phase 7's
   bars.
23. The float64 render (``dtype=torch.float64``), on the staged route the
   JAX package runs in float64: (a) each float64 instantiation of the
   march kernel (``march_kernel_f64``: midpoint and jets on the 1080p AD
   frames' recorded rays, AB3 through ``march_u`` on the 1080p flagship
   rays, the KMAX 8 build on phase 22(d)'s near-critical rays) against
   its plain version: the integers equal, every float within 1e-12
   (``F64_MARCH_BAR``), the AB3 march's outputs bit-equal; its ms,
   registers, spill and bound at the FP64 rate (``bound64``: 33.5
   TFLOP/s, half the FP32 rate); for the AB3 march also its stack frame,
   its shared memory per block (its history's ring), the lane efficiency
   of its step loop (the lane-counting copy's busy lane-steps over 32 x its
   warps' steps) and its step loop's SASS census with its local-memory
   loads and stores. The three 1080p float64 marches stay within 5% of
   ``PARENT_KERNEL_MS`` (the midpoint and jets marches' times before the
   AB3 march's redesign, ``F64_AB3_MARCH_MS`` after it). (b) Each float64
   gradient instantiation (``march_grad_kernel_f64``, without and with
   the jets) against the plain VJP in float64 on the AD frame's rays, the
   jets crop (phase 22(a)'s, in float64), the K = 8 sample and a seeded
   65,536 of phase 7's recorded rays cast to float64: ray p95 and p99.9
   rel below 1e-9 and 1e-7, the partials below 1e-8 (float32's: 1e-2,
   2e-3, 1e-3); ms, registers, spill, shared memory per block, the reverse
   and replay kernels' warps per SM, the lane efficiency of the reverse
   kernel's warps (the lane-counting copy's busy lane-steps over 32 x its
   warps' steps) beside one thread per ray's on the same rays, the SASS
   census of its reverse loop, and the 1080p jets frame's time with its
   bound. The float64 gradient on the AD frames, and the float32
   gradient on phases 7 and 22, stay within 5% of ``PARENT_KERNEL_MS``
   (``F64_GRAD_MS``, ``F64_JETS_GRAD_MS``: the redesigned kernel's). (c) The
   1080p AD frames (flagship and jets) in float64 with the seven leaves as
   float64 tensors: forward and forward + backward (median of 5), every
   gradient finite, one march and one gradient launch a frame; the oracle
   gradient gates through ``render_radiance(..., dtype=float64)``. (d) The
   fused flagship frame (exact route, 160x90) in float64: float32 planes,
   the render kernel against the CPU port's plain version on the same
   float64-built row (p99 |d| < 1e-4), the row differing from float32's.
   (e) ``render_sharded`` under autograd at 480x270 (the whole frame
   bloomed, so no pixel is exactly black), worlds 1 (NCCL in-process), 2
   and 3 (spawned gloo processes on the one card), float32 and float64:
   every rank's leaf gradients identical and within ``F64_MD_REL`` of the
   single-device twin's, the image bit-equal to the twin's ``render``.
24. The composite kernel and its VJP kernel (``csrc/composite.cu``) on the
   inputs of one step of the inverse cell (``benchmark/configs/
   inverse_1080p.json``, stage 1: 2,073,600 rays, K = 4, analytic disk,
   starfield, glow), recorded from ``make_ad_inverse_step``: each kernel
   alone (20 launches) beside its bound (each input byte the rays need
   read once, each output written once; the operations counted by the
   plain twin's arithmetic ops on one ray of each kind, ``composite_ops``),
   the plain composite's forward and its autograd forward + backward on
   the same inputs (their peak memory beside the kernels'), the forward
   bit-equal to the plain composite's, the VJP within 1e-5 of the plain
   twin's (``composite_vjp_plain``), two backward calls bit-equal, and
   ptxas's registers and spills of the instantiation.
25. The deterministic inverse fit re-read: one whole fit of the inverse
   cell (60 steps: 20 of each stage), every step held against the
   benchmark's reference (``benchmark/reference/inverse.py``) from its
   entering state: each step's ``loss_rel``, ``grad_rel`` and
   ``update_rel`` and their largest, which stay below the cell's limits
   (``benchmark/limits/inverse_1080p.ad_curriculum.json``). About 14
   minutes of the H100 (the reference takes ~13 s a step).

26. The birth kernel and its VJP kernels (``csrc/birth.cu``) at the
   inverse cell's first step (1920x1080, the step's row-major ids, the
   fit's initial spin and theta): each alone (20 launches) beside its
   bound (each id read once, each row written once; the VJP reads the six
   cotangent rows that depend on the inputs), the plain chain's forward
   and its autograd forward + backward, the forward bit-equal to the plain
   chain's, and the VJP for two cotangents (the step's own, recorded from
   ``make_ad_inverse_step``, and a seeded uniform one) against autograd of
   the plain chain in float32 and in float64 (the float32 chain's inputs
   and cotangent cast) and against the plain twin; two backward calls
   bit-equal, and ptxas's registers and spills.

``python3 chip_smoke.py composite inverse_fit birth`` runs phases 24, 25
and 26 alone (each kernel built at its first use).

A kernel "alone" is timed over a run of back-to-back launches between two
CUDA events (ms per launch); frames, steps and the refinement pass are
timed per call. It prints the card's name and power limit (nvidia-smi),
then a JSON line describing each kernel, then the last line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from blackhole_simulation_tpu_torch.app import cli  # noqa: E402
from blackhole_simulation_tpu_torch.app import live  # noqa: E402
from blackhole_simulation_tpu_torch.app.screenshot import (  # noqa: E402
    encode_png,
    load_png_rgb,
)
from blackhole_simulation_tpu_torch.configs import (  # noqa: E402
    SimulationParams,
    scene_from_params,
)
from blackhole_simulation_tpu_torch.engine.cinema import (  # noqa: E402
    grand_survey,
)
from blackhole_simulation_tpu_torch.parallel.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from blackhole_simulation_tpu_torch.engine import (  # noqa: E402
    NativeBridge,
    PhysicsEngine,
)
from blackhole_simulation_tpu_torch.geodesic.integrate import (  # noqa: E402
    integrate,
)
# The module (the package re-exports the function under its name).
integrate_module = importlib.import_module(
    "blackhole_simulation_tpu_torch.geodesic.integrate")
from blackhole_simulation_tpu_torch.models.nrs import (  # noqa: E402
    generate_training_data,
    nrs_far_field_rows,
    nrs_init,
    train_nrs,
)
from blackhole_simulation_tpu_torch.ops import build as kbuild  # noqa: E402
from blackhole_simulation_tpu_torch.ops import pallas_march  # noqa: E402
from blackhole_simulation_tpu_torch.ops.ks_kernel import (  # noqa: E402
    ks_renormalize_pr,
)
from blackhole_simulation_tpu_torch.ops.march import (  # noqa: E402
    march_step_rows,
)
from blackhole_simulation_tpu_torch.ops.march_adjoint import (  # noqa: E402
    march_step_vjp_at,
    renorm_discriminant,
    turning_point_states,
)
from blackhole_simulation_tpu_torch.ops.march_grad import (  # noqa: E402
    CKPT,
    CKPT_F64,
    grad_kernel_shape,
    march_grad,
    march_grad_kernel,
    minmax_check,
    renorm_vjp_check,
    step_vjp_check,
)
from blackhole_simulation_tpu_torch.ops.pallas_march import (  # noqa: E402
    lane_efficiency,
    march_kernel_shape,
    march_u,
    march_u_plain,
    ray_pool,
)
from blackhole_simulation_tpu_torch.ops.render import (  # noqa: E402
    launch_steps,
    render_kernel_shape,
    render_planes,
    render_planes_kernel,
)
from blackhole_simulation_tpu_torch.ops.tonemap import (  # noqa: E402
    tonemap_kernel,
    tonemap_kernel_shape,
)
from blackhole_simulation_tpu_torch.geodesic import (  # noqa: E402
    oracle as oracle_module,
)
from blackhole_simulation_tpu_torch.geodesic.oracle import (  # noqa: E402
    oracle_march,
)
from blackhole_simulation_tpu_torch.parallel import (  # noqa: E402
    InverseParams,
    ad_inverse_render,
    fd_state_init,
    inverse_render,
    make_fd_inverse_step,
    make_inverse_step,
    make_mesh,
    render_sharded,
)
from blackhole_simulation_tpu_torch.parallel.render import (  # noqa: E402
    single_device_twin,
)
from blackhole_simulation_tpu_torch.parallel.train import (  # noqa: E402
    _forward,
)
from blackhole_simulation_tpu_torch.render.camera import (  # noqa: E402
    Camera,
    camera_rays,
    camera_rays_indexed,
    camera_rays_u,
)
from blackhole_simulation_tpu_torch.render.march import (  # noqa: E402
    HIT_ESCAPE,
    HIT_NONE,
    MarchConfig,
    MarchRows,
    _kernel_cfg,
    _march_inputs,
    march,
    march_rows,
    march_rows_ad,
    refinement_config,
)
from blackhole_simulation_tpu_torch.render.accumulate import (  # noqa: E402
    TemporalAccumulator,
)
from blackhole_simulation_tpu_torch.render.pipeline import (  # noqa: E402
    Features,
    Scene,
    conserved_lam,
    ensure_spectral_coeffs,
    halton_jitters,
    kernel_inputs,
    refine_critical_band,
    render,
    render_radiance,
    render_sample,
    render_sample_scaled,
    select_band,
    shade_march_rows,
    shade_sample,
)
from blackhole_simulation_tpu_torch.render.post import (  # noqa: E402
    tonemap,
    tonemap_plain,
)
from blackhole_simulation_tpu_torch.render.shading import (  # noqa: E402
    JetParams,
    StarfieldParams,
    disk_luts,
    escape_direction,
    escape_direction_u_rows,
)
from blackhole_simulation_tpu_torch.render.tiles import (  # noqa: E402
    ProgressiveRenderer,
)
from blackhole_simulation_tpu_torch.render.precull import (  # noqa: E402
    critical_band_metric_u,
)
from blackhole_simulation_tpu_torch.tools import grad_census  # noqa: E402
from blackhole_simulation_tpu_torch.tools import march_census  # noqa: E402
from blackhole_simulation_tpu_torch.tools import sass_census  # noqa: E402
from blackhole_simulation_tpu_torch.tools import train_probe  # noqa: E402
from blackhole_simulation_tpu_torch.tools import vpu_peak  # noqa: E402

SOURCES = ("render.cu", "march.cu", "march_grad.cu", "vpu_peak.cu",
           "step_vjp_check.cu", "tonemap.cu")
# Published float32 peak of one H100 SXM outside the tensor cores (FLOP/s,
# an FMA counted as two), the same in lane FMA instructions per second, and
# the memory rate (bytes/s).
FP32_PEAK = 67e12
LANE_PEAK = FP32_PEAK / 2
HBM_RATE = 3.35e12
# The measured lane-FMA rate of phase 1 (instructions/s). Every operation
# bound divides by the larger of it and LANE_PEAK.
LANE_RATE = None
# Operations of the kernel, counted by hand from csrc/render.cu with every
# add, multiply, divide, square root and compare as one: one march step with
# midpoint_iters = 1 (two Kerr-Schild right-hand sides of ~121 each, the
# adaptive step size, the updates, the crossing record and the sanity test,
# plus the renormalization spread over its 16 steps), and what every pixel
# does outside the march (ray birth, null projection, the 32-term Chebyshev
# precull). The composite (disk slots, starfield, glow) depends on each
# ray's crossings and fate and is not counted, so the bound is a lower one.
OPS_PER_STEP = 340
OPS_PER_PIXEL = 260
# One AB3 step counted the same way: one right-hand side (~121), the step
# size and its growth bound, the three Lagrange coefficients (~28), the
# three-term updates of the six rows (36), the crossing record and the
# sanity test.
OPS_PER_STEP_AB3 = 245
# The band plane's metric (and the pole fold, when on) per pixel, beside
# the precull's Chebyshev sum already in OPS_PER_PIXEL.
OPS_PER_PIXEL_BAND = 12
# The jets' term of one march step, counted the same way: the step's
# direction (dr, dtheta, dphi from 1/dlam, ~12), the cone test and profile
# (~14, exp as one), the direction cosine and beaming (~25, pow as one),
# one value-noise octave (four lattice hashes of ~20 and the blend, ~95),
# the turbulence, the magnitude and the three sums (~15).
OPS_PER_STEP_JETS = 160
# The same steps on the approx_recip route, whose multiply-adds are
# contracted (march_step.cuh::madd): each fused pair is one lane
# instruction, so it counts one. Counted from the code: a right-hand side
# fuses 21 pairs, the midpoint step's two updates of six rows 12, the
# crossing record 3, the step size's sigma 1 (the same expression as the
# first right-hand side's S, which the compiler shares): 58 per midpoint
# step; an AB3 step fuses one right-hand side (21), its coefficients (4),
# its three-term updates (18) and the crossing record (3): 46. The jets'
# sample has no contracted term (its exp and pow, in float on this route,
# count one each as before). The renormalization stays uncontracted.
OPS_PER_STEP_FUSED = OPS_PER_STEP - 58
OPS_PER_STEP_AB3_FUSED = OPS_PER_STEP_AB3 - 46
OPS_PER_STEP_JETS_FUSED = OPS_PER_STEP_JETS
# Per pixel: the start offset (one midpoint step and its hash, ~365), the
# overlay (64 segments of ~21 and the prologue, ~1365) and the NRS skip
# test (~8); per far pixel the NRS background (the MLP's ~1,200 multiplies
# and adds and 48 tanh, the birth direction, the rotation and the
# starfield, ~1,500).
OPS_PER_PIXEL_JITTER = 365
OPS_PER_PIXEL_OVERLAY = 1365
OPS_PER_PIXEL_NRS = 8
OPS_PER_FAR_PIXEL = 1500
# The tone map's operations per pixel, each add, multiply, divide, compare
# and pow as one, counted from csrc/tonemap.cu without the halo's
# recomputation: the exposure (3), the bright pass (luma 5, threshold and
# its clamp 2, 3 products), four 9-tap passes on three channels, each
# output 5 products (its symmetric weights share one product between two
# taps) and 8 adds (4 x 3 x 13), the combine (6), ACES (3 x 10 with its
# clamp, after which the clip is no operation) and the pow (3); and its
# bytes: three float32 values read and three written.
TONEMAP_OPS_PER_PIXEL = 3 + 10 + 4 * 3 * 13 + 6 + 30 + 3
TONEMAP_BYTES_PER_PIXEL = 24
# The flagship instantiations' registers and spills (render.cu midpoint
# on the approx_recip route, render_kernel<0, false, true>, and march.cu's
# midpoint on it, march_kernel<0, true>, the training step's; both 56 / 0
# before the step's redesign, when approx was a runtime flag), and the
# spread of the certified render's slice's phase-4 frames (ms, H100 80GB
# HBM3 at 700 W): a later slice keeps both.
FLAGSHIP_MARKERS = {"render.cu": "ILi0ELb0ELb1E", "march.cu": "ILi0ELb1E"}
FLAGSHIP_REGISTERS = {"render.cu": (48, 0), "march.cu": (64, 0)}
FLAGSHIP_FRAME_SPREAD_MS = (6.131, 6.814)
FLAGSHIP_KERNEL_SPREAD_MS = (1.349, 1.366)
# The float64 gradient kernel's times on phase 23's 1080p AD frames after
# its redesign (the replay kernel and the reverse kernel, ms per launch
# through march_grad_kernel, H100 80GB HBM3 at 700 W, PERF.md).
F64_GRAD_MS = 15.15
F64_JETS_GRAD_MS = 22.00
# The float64 AB3 march kernel's time on phase 23's 1080p flagship rays
# after its redesign, through march_u as phase 23 times it (ms per launch,
# the slower of two runs, H100 80GB HBM3 at 700 W, PERF.md).
F64_AB3_MARCH_MS = 2.017
# The frame is ~80% host work and tonemap, which vary with the host the
# card shares; the kernel alone does not. The frame may exceed PR 3's
# spread by this factor, the kernel by 5%.
FRAME_SLACK = 1.25
# The kernel alone on each 1080p render path and the staged AB3 march after
# the step's redesign (the step-redesign slice's commit), the slower of the
# change's two runs in its first comparison call (H100 80GB HBM3 at 700 W,
# PERF.md): a later slice stays within 5% of them.
PARENT_KERNEL_MS = {"flagship render": 0.993, "certified render": 1.000,
                    "AB3 render": 0.999, "jets render": 2.105,
                    "full-featured render": 2.198, "staged AB3 march": 1.033,
                    # the gradient kernel (PERF.md's kernel table): phase 7's
                    # and phase 22's float32 times before the float64
                    # kernel's redesign, and the redesigned float64 kernel's
                    # on phase 23's 1080p AD frames
                    "training gradient": 7.684,
                    "AD flagship gradient": 12.30,
                    "AD jets gradient": 17.63,
                    "float64 AD flagship gradient": F64_GRAD_MS,
                    "float64 AD jets gradient": F64_JETS_GRAD_MS,
                    # the float64 march kernel on phase 23's 1080p rays:
                    # the midpoint and jets instantiations before the AB3
                    # one's redesign, the AB3 one after it
                    "float64 AD flagship march": 2.155,
                    "float64 AD jets march": 3.536,
                    "float64 AB3 march": F64_AB3_MARCH_MS}
PARENT_SLACK = 1.05
# The gradient kernel's least work per live march step, in march steps: the
# checkpointing replay, the block's re-forward, and one reverse-mode VJP of
# the step at about three times the step's operations (a transposed
# multiply is two multiplies and an add). Its bytes: each live block's
# checkpoint through the scratch buffer besides its inputs and outputs (the
# re-forward stack stays in shared memory).
GRAD_STEPS_PER_STEP = 2 + 3
# Phase 7's per-step check of the gradient kernel's adjoint against the
# dual pass, on a seeded sample of the 1080p step's rays at every live step.
# The relative difference (floored at 1e-6, as grad_compare's): its 99th
# percentile, and the share of elements above 1e-3. And every element's
# difference over the size of its derivative's terms (the sum of their
# absolute values, which float32 rounding of either route moves the result
# by a small multiple of eps of, however much the terms cancel).
STEP_CHECK_RAYS = 65536
STEP_CHECK_P99_BAR = 1e-4
STEP_CHECK_TAIL_BAR = 1e-3
STEP_CHECK_SIZE_BAR = 1e-4
# The mirror of the adjoint (ops/march_adjoint.py) against the header on
# rays of the same step at exact divides, every live step: bit-equal.
MIRROR_CHECK_RAYS = 4096
# The renormalization's VJP alone at planted radial turning points: the
# adjoint's largest difference from the dual pass, over the largest |dual|
# cotangent of the same state (near a double root the small cotangents are
# cancellations at float32 rounding of the large ones).
RENORM_CHECK_BAR = 1e-5
# The step's 11 inputs, in the order of the VJP's rows.
STEP_INPUTS = ("t", "r", "u", "ph", "pr", "pu", "pph", "m", "a", "r_h",
               "r_ph")
# The device of phases 5-7.
DEV = "cuda"
FLAGSHIP_CFG = MarchConfig(
    max_steps=256, use_pallas=True, fused=True, shadow_precull=True,
    step_rate=0.2, far_step_cap_rate=0.4, far_boost_radius=20.0,
    approx_recip=True, midpoint_iters=1,
)
# bench.py's training step: the flagship MarchConfig on the staged path.
TRAIN_CFG = dataclasses.replace(FLAGSHIP_CFG, fused=False, remat_every=0)
# Phase 5: the staged render against the fused one at 480x270: the mean
# |d| over all pixels, and over those with |d| <= 1e-2 (test_fused.py's).
STAGED_MEAN_BAR = 5e-5
STAGED_MEAN_REST_BAR = 1e-5
# Phase 7: the tail of the gradient kernel's per-ray relative difference
# from its plain version at 1080p (each ray's worst initial-row cotangent):
# its 99.9th percentile, and the share of rays above 1e-3.
GRAD_P999_BAR = 2e-3
GRAD_TAIL_BAR = 2e-3


def flagship_scene(width, height, spin=0.999, cfg=FLAGSHIP_CFG,
                   features=Features(spectral_lut=True)):
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=width, height=height)
    return Scene.create(mass=1.0, spin=spin, camera=cam, march_cfg=cfg,
                        features=features)


def plain_twin(st):
    """The plain version's inputs: the same config with exact divides."""
    return dataclasses.replace(
        st, cfg=dataclasses.replace(st.cfg, approx_recip=False))


def step_ops(variant, approx):
    """Counted operations of one march step of ``variant`` ("midpoint",
    "ab3", "jets") on the approx_recip route (contracted) or the exact
    one."""
    if variant == "ab3":
        return OPS_PER_STEP_AB3_FUSED if approx else OPS_PER_STEP_AB3
    mid = OPS_PER_STEP_FUSED if approx else OPS_PER_STEP
    if variant == "jets":
        return mid + (OPS_PER_STEP_JETS_FUSED if approx else OPS_PER_STEP_JETS)
    return mid


def parent_gate(name, ms):
    """Fail when the kernel alone on ``name``'s path is more than 5% slower
    than its reference time (PARENT_KERNEL_MS)."""
    ref = PARENT_KERNEL_MS[name]
    print(f"{name}: kernel {ms:.4f} ms, reference (PARENT_KERNEL_MS) {ref} "
          f"ms, ratio {ms / ref:.4f}")
    if not ms <= ref * PARENT_SLACK:
        raise AssertionError(f"{name} kernel {ms} ms is more than 5% above "
                             f"its reference {ref} ms")


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the counted operations over the
    lane rate (the larger of the measured and the published one) and the
    bytes over the memory rate."""
    ops_ms = ops / max(LANE_RATE or 0.0, LANE_PEAK) * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def diff_stats(a, b):
    d = (a - b).abs()
    return {
        "max_abs": float(d.max()),
        "mean_abs": float(d.mean()),
        "p99_abs": float(torch.quantile(d.flatten().double(), 0.99)),
        "frac_gt_1e-2": float((d.amax(dim=0) > 1e-2).float().mean()),
    }


def kernel_time(fn, n):
    """(ms per launch, the last call's result) of ``fn`` (one kernel's
    wrapper): one warm-up call, then n calls back to back between two CUDA
    events, so that no host gap between launches is timed."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, out


def timed(fn, n):
    """ms of n calls, each bracketed by CUDA events: (median, min, max)."""
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(min(times)), float(max(times))


# The float64 gradient kernel's lane-counting copy (tools/grad_census.py::
# count_lanes) and the march kernel's (tools/march_census.py::count_lanes),
# built in phase 1 beside the sources, read in phase 23.
LANE_COUNT_LIB = None
MARCH_COUNT_LIB = None


def phase_build():
    global LANE_COUNT_LIB, MARCH_COUNT_LIB
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES) + 2) as pool:
        count = pool.submit(grad_census.build_copy, grad_census.CSRC,
                            "count", grad_census.count_lanes)
        march_count = pool.submit(grad_census.build_copy, march_census.CSRC,
                                  "count", march_census.count_lanes,
                                  "march.cu", march_census.WORK)
        libs = list(pool.map(kbuild.build, SOURCES))
        LANE_COUNT_LIB = grad_census.GradLib(count.result()[0], pool=True)
        MARCH_COUNT_LIB = march_census.MarchLib(march_count.result()[0])
    secs = time.perf_counter() - t0
    print(f"build: {len(libs)} kernel source(s) and the float64 gradient "
          f"and march kernels' lane-counting copies in {secs:.1f} s")
    for src in SOURCES:
        for entry, regs, spill in kbuild.ptxas_usage(src):
            print(f"ptxas {src}: {entry}: {regs} registers, {spill} bytes "
                  "spilled")
    regs, spill = registers("march_grad.cu", "ILb1ELb0E")
    shape = grad_kernel_shape()
    print(f"gradient kernel (march_grad.cu, approx_recip): {regs} registers, {spill} bytes "
          f"spilled, {shape['smem_bytes']} bytes of dynamic shared memory per "
          f"{shape['threads']}-thread block (a {shape['ckpt']}-step stack)")
    shape = grad_kernel_shape(False, False, F64)
    print(f"float64 gradient: reverse kernel {shape['smem_bytes']} bytes of "
          f"dynamic shared memory per {shape['threads']}-thread block (a "
          f"{shape['ckpt']}-step tape), {shape['warps_per_sm']} warps per SM; "
          f"replay kernel {shape['replay']['warps_per_sm']} warps per SM")
    return secs


def registers(src, marker=""):
    """(registers, spill bytes) of the kernel of ``src`` whose mangled name
    holds ``marker``."""
    return next((r, s) for e, r, s in kbuild.ptxas_usage(src) if marker in e)


def phase_peak():
    """The measured FP32 rate, and the probe's measuring launch against its
    plain version on the same starts."""
    global LANE_RATE
    vpu_peak.fma_chains.launches = 0
    peak, k = vpu_peak.measure()
    launches = vpu_peak.fma_chains.launches
    LANE_RATE = peak["lane_fma_per_s"]
    n = peak["grid"] * peak["threads"]
    x = vpu_peak.starts(peak["chains"], n, DEV)
    t0 = time.perf_counter()
    p = vpu_peak.fma_chains_plain(x, peak["iters"], peak["unroll"])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rel = float(((k - p).abs() / p.abs()).max())
    equal = bool(torch.equal(k, p))
    if not rel < 1e-6:
        raise AssertionError(f"FP32 probe vs plain: rel {rel}")
    ms = peak["seconds_per_call"] * 1e3
    fmas = n * peak["chains"] * peak["iters"] * peak["unroll"]
    bound_ms, bound_by = bound(fmas, 4 * (peak["chains"] + 1) * n)
    print(f"FP32 peak: {LANE_RATE:.6e} lane FMA/s, {peak['flop_per_s']:.6e} "
          f"FLOP/s; published {FP32_PEAK:.3e} FLOP/s ({LANE_PEAK:.3e} lane "
          f"FMA/s); measured/published {peak['flop_per_s'] / FP32_PEAK:.4f};"
          f" bounds divide by {max(LANE_RATE, LANE_PEAK):.6e} lane FMA/s; "
          f"probe vs plain ({n} threads, "
          f"{peak['iters'] * peak['unroll']} steps per chain) rel {rel:.3e}, "
          f"bit-equal {equal}; {json.dumps(peak)}")
    return {
        "name": "vpu_peak", "route": "cuda",
        "source": "blackhole_simulation_tpu_torch/csrc/vpu_peak.cu",
        "replaces": "tools/vpu_peak.py:65", "launches": launches,
        "max_abs_err": float((k - p).abs().max()), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "lane_fma_per_s": LANE_RATE,
        "flop_per_s": peak["flop_per_s"], "published_flop_per_s": FP32_PEAK,
        "published_lane_fma_per_s": LANE_PEAK,
        "measured_over_published": peak["flop_per_s"] / FP32_PEAK,
        "probe_rel": rel, "probe_bit_equal": equal,
    }


def phase_short_parity():
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48, approx_recip=False)
    out = {}
    for name, feats in (("spectral", Features(spectral_lut=True)),
                        ("analytic", Features())):
        row, st = kernel_inputs(flagship_scene(250, 141, spin=0.9, cfg=cfg,
                                           features=feats), None, "cuda")
        k = render_planes_kernel(row, st)
        p = render_planes(row, st)
        torch.cuda.synchronize()
        s = diff_stats(k, p)
        print(f"short-horizon parity ({name}, 250x141, 48 steps): {s}")
        if not (s["p99_abs"] < 1e-4 and s["mean_abs"] < 1e-5):
            raise AssertionError(f"short-horizon parity failed ({name}): {s}")
        out[name] = s
    return out


def approx_bars(k, p):
    """Phase 3's bars for the approx_recip route against the exact plain
    version: all finite, mean |d| < 1e-3, under 1% of pixels with some
    channel above 1e-2 (the chaotic critical-band rays)."""
    s = diff_stats(k, p)
    s["finite"] = bool(torch.isfinite(k).all())
    s["ok"] = (s["finite"] and s["mean_abs"] < 1e-3
               and s["frac_gt_1e-2"] < 0.01)
    return s


def plain_march(yt0, thr, m, a, r_h, r_ph, cfg, jets=None, out=None):
    """``march_u``'s signature on ``march_u_plain`` (exact divides)."""
    return march_u_plain(yt0, thr, m, a, r_h, r_ph, cfg, jets)


def staged_plain(scene):
    """The staged render of ``scene`` on the card with the plain march in
    place of the march kernel (``render/march.py`` looks ``march_u`` up at
    each call)."""
    kernel = pallas_march.march_u
    pallas_march.march_u = plain_march
    try:
        return render_radiance(scene, device=DEV)
    finally:
        pallas_march.march_u = kernel


def phase_flagship_parity():
    """Phase 3: the approx_recip route at 480x270, 256 steps, against the
    plain version at exact divides: the render kernel's flagship (spectral),
    AB3, jets and full-featured instantiations, and the march kernel's
    midpoint and AB3 ones (staged renders, the plain march in place of the
    kernel) and its jets one (the jets' radiance rows of 480x270 camera
    rays)."""
    ab3 = dataclasses.replace(FLAGSHIP_CFG, multistep=True)
    out = {}
    for name, scene in (
            ("flagship", flagship_scene(480, 270)),
            ("ab3", flagship_scene(480, 270, cfg=ab3)),
            ("jets", branch_scene("jets", 480, 270, FLAGSHIP_CFG)),
            ("full-featured", branch_scene("all", 480, 270, FLAGSHIP_CFG))):
        row, st = kernel_inputs(scene, None, DEV)
        k = render_planes_kernel(row, st)
        p = render_planes(row, plain_twin(st))
        torch.cuda.synchronize()
        s = approx_bars(k, p)
        print(f"approx_recip route, render kernel {name} (480x270, 256 "
              f"steps) vs plain: {s}")
        if not s["ok"]:
            raise AssertionError(f"approx route, render {name}: {s}")
        out[f"render_{name}"] = s
    for name, cfg in (("midpoint", FLAGSHIP_CFG), ("ab3", ab3)):
        scene = flagship_scene(480, 270, features=Features(),
                               cfg=dataclasses.replace(cfg, fused=False))
        march_u.launches = 0
        k = render_radiance(scene, device=DEV)
        launches = march_u.launches
        p = staged_plain(scene)
        torch.cuda.synchronize()
        s = approx_bars(k.permute(2, 0, 1), p.permute(2, 0, 1))
        s["march_launches"] = launches
        print(f"approx_recip route, march kernel {name} (staged 480x270, "
              f"256 steps) vs the plain march: {s}")
        if not (s["ok"] and launches >= 1):
            raise AssertionError(f"approx route, march {name}: {s}")
        out[f"march_{name}"] = s
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.9)
    cfg = dataclasses.replace(FLAGSHIP_CFG, fused=False, shadow_precull=False)
    with torch.no_grad():
        args = _march_inputs(camera_rays_u(_camera(480, 270), m, a), m, a,
                             cfg, None)
        k = march_u(*args, cfg, JetParams())[8]
        p = march_u_plain(*args, cfg, JetParams())[8]
    torch.cuda.synchronize()
    s = approx_bars(k.reshape(3, 270, 480), p.reshape(3, 270, 480))
    print(f"approx_recip route, march kernel jets (480x270 camera rays, 256 "
          f"steps), jet radiance vs plain: {s}")
    if not s["ok"]:
        raise AssertionError(f"approx route, march jets: {s}")
    out["march_jets"] = s
    return out


def render_frames(scene, frames=30, warmup=3):
    """``render(scene)``: ``warmup`` frames, then ``frames`` timed by CUDA
    events with the render and march kernels' launch counters reset just
    before and read just after, then one more frame checked to be a finite
    tone-mapped (H, W, 3) image. Returns ((median, min, max) ms, launches)."""
    for _ in range(warmup):
        render(scene)
    torch.cuda.synchronize()
    render_planes_kernel.launches = 0
    march_u.launches = 0
    tonemap_kernel.launches = 0
    times = timed(lambda: render(scene), frames)
    launches = {"render": render_planes_kernel.launches,
                "march": march_u.launches,
                "tonemap": tonemap_kernel.launches}
    img = render(scene)
    torch.cuda.synchronize()
    if launches["render"] < frames or launches["tonemap"] != frames:
        raise AssertionError(f"render and tone-map kernel launches in "
                             f"{frames} frames: {launches}")
    shape = (scene.camera.height, scene.camera.width, 3)
    if img.shape != shape or not bool(torch.isfinite(img).all()):
        raise AssertionError("render() output is not a finite (H, W, 3) image")
    if not (0.0 <= float(img.min()) and float(img.max()) <= 1.0):
        raise AssertionError("tone-mapped image outside [0, 1]")
    return times, launches


def render_kernel_entry(scene, launches, ops_per_step, ops_per_pixel,
                        bytes_per_pixel, replaces, **extra):
    """The render kernel alone on the scene's row (CUDA events), its plain
    version once at exact divides, the comparison (mean |d| < 1e-3, under
    1% of pixels above 1e-2) and the bound from this run's steps: a
    kernels-line entry. Also returns the comparison, the kernel's planes
    and its static configuration."""
    row, st = kernel_inputs(scene, None, DEV)
    height, width = st.height, st.width
    steps = torch.empty((height, width), dtype=torch.int32, device=DEV)
    k = render_planes_kernel(row, st, steps)
    kernel_ms, _ = kernel_time(lambda: render_planes_kernel(row, st), 20)
    t0 = time.perf_counter()
    p = render_planes(row, plain_twin(st))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    s = diff_stats(k, p)
    if not (bool(torch.isfinite(k).all()) and s["mean_abs"] < 1e-3
            and s["frac_gt_1e-2"] < 0.01):
        raise AssertionError(f"{width}x{height} kernel vs plain failed: {s}")
    n_pix = width * height
    total_steps = int(steps.long().sum())
    bound_ms, bound_by = bound(ops_per_step * total_steps
                               + ops_per_pixel * n_pix,
                               bytes_per_pixel * n_pix + 4 * row.numel())
    entry = {
        "name": "render", "route": "cuda",
        "source": "blackhole_simulation_tpu_torch/csrc/render.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": s["max_abs"], "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "p99_abs": s["p99_abs"], "mean_abs": s["mean_abs"],
        "steps_per_ray": total_steps / n_pix, "steps_sum": total_steps,
        "steps_max": int(steps.max()),
        "lane_efficiency": lane_efficiency(launch_steps(steps)),
        "resident_warps_per_sm": render_kernel_shape(st)["warps_per_sm"],
        **extra,
    }
    return entry, s, k, st


def phase_main_path(frames=30):
    width, height = 1920, 1080
    n_pix = width * height
    scene = flagship_scene(width, height)
    (frame_ms, frame_min, frame_max), launches = render_frames(scene, frames)
    entry, s, k, _ = render_kernel_entry(
        scene, launches["render"], step_ops("midpoint", True), OPS_PER_PIXEL,
        12, "blackhole_simulation_tpu/ops/pallas_render.py:140",
        path="flagship render()", variant="midpoint")
    print(f"1080p kernel vs plain: {s}")
    parent_gate("flagship render", entry["ms"])

    # Where the frame's time goes besides the kernel.
    t0 = time.perf_counter()
    for _ in range(10):
        kernel_inputs(scene, None, DEV)
    torch.cuda.synchronize()
    row_ms = (time.perf_counter() - t0) * 1e2
    planes = k[:3].permute(1, 2, 0)
    tonemap_ms, _, _ = timed(lambda: tonemap(planes, scene.post), 10)
    print(f"main path: render() 1920x1080 flagship: {frame_ms:.3f} ms/frame "
          f"median of {frames}, {n_pix / frame_ms / 1e3:.1f} Mrays/s; kernel "
          f"{entry['ms']:.3f} ms; host row build + copy {row_ms:.3f} ms; "
          f"tonemap {tonemap_ms:.3f} ms; plain {entry['plain_ms']:.1f} ms; "
          f"steps/ray {entry['steps_per_ray']:.1f}; launches {launches}")
    entry.update(frame_ms=frame_ms, frame_ms_min_max=[frame_min, frame_max],
                 mrays_per_s=n_pix / frame_ms / 1e3, host_row_ms=row_ms,
                 tonemap_ms=tonemap_ms, frames=frames)
    return entry, tonemap_entry(planes, scene.post, launches["tonemap"],
                                frames)


def _bit_equal(a, b):
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def tonemap_entry(planes, post, launches, frames):
    """Phase 4's tone map on the 1080p frame's radiance: the kernel alone
    on the render's planar view and on a contiguous copy, each bit-equal to
    the plain path (``tonemap_plain``), beside the plain path's time, the
    bound, ptxas's registers and spill, the launch shape (tile, shared bytes,
    warps per SM), and the float64 instantiation on the same frame. The
    kernels-line entry."""
    h, w, _ = planes.shape
    n_pix = h * w
    contiguous = planes.contiguous()
    want = tonemap_plain(planes, post)
    for name, img in (("planar", planes), ("contiguous", contiguous)):
        if not _bit_equal(tonemap_kernel(img, post), want):
            raise AssertionError(f"tone-map kernel ({name} 1080p) differs "
                                 "from tonemap_plain")
    ms, _ = kernel_time(lambda: tonemap_kernel(planes, post), 100)
    ms_contiguous, _ = kernel_time(lambda: tonemap_kernel(contiguous, post),
                                   100)
    plain_ms, _, _ = timed(lambda: tonemap_plain(planes, post), 10)
    f64 = planes.double()
    if not _bit_equal(tonemap_kernel(f64, post), tonemap_plain(f64, post)):
        raise AssertionError("float64 tone-map kernel (1080p) differs from "
                             "tonemap_plain")
    f64_ms, _ = kernel_time(lambda: tonemap_kernel(f64, post), 50)
    bound_ms, bound_by = bound(TONEMAP_OPS_PER_PIXEL * n_pix,
                               TONEMAP_BYTES_PER_PIXEL * n_pix)
    bytes_ms = TONEMAP_BYTES_PER_PIXEL * n_pix / HBM_RATE * 1e3
    # tonemap_kernel<float, 2, BRIGHT, true, true>: two passes and ACES
    regs, spill = registers("tonemap.cu", "IfLi2EL4Load1ELb1ELb1E")
    shape = tonemap_kernel_shape(post)
    print(f"tone-map kernel (1080p, flagship post): {ms:.4f} ms alone on "
          f"the planar view, {ms_contiguous:.4f} on a contiguous image, "
          f"bit-equal to the plain path ({plain_ms:.3f} ms); bound "
          f"{bound_ms:.4f} ms by {bound_by} (bytes alone {bytes_ms:.4f}); "
          f"{regs} registers, {spill} bytes spilled, {shape}; float64 "
          f"{f64_ms:.4f} ms; {launches} launches in {frames} frames")
    return {
        "name": "tonemap", "route": "cuda",
        "source": "blackhole_simulation_tpu_torch/csrc/tonemap.cu",
        "replaces": None, "launches": launches, "frames": frames,
        "ms": ms, "ms_contiguous": ms_contiguous, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes_ms": bytes_ms,
        "library_ms": None, "bit_equal": True, "f64_ms": f64_ms,
        "registers": regs, "spill": spill, **shape,
        "resident_warps_per_sm": shape["warps_per_sm"],
    }


def _rel(x, ref):
    return abs(x - ref) / max(abs(ref), 1e-9)


def _camera(width, height):
    return Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                         width=width, height=height)


def _cuda_scalar(v, grad=False, dtype=torch.float32):
    return torch.tensor(v, dtype=dtype, device=DEV, requires_grad=grad)


def march_compare(k, p):
    """Kernel vs plain march outputs: the share of rays whose hit, steps or
    crossing count differ, the share whose float outputs differ by more
    than 1e-4, and the largest |d| over the rays whose integers agree."""
    same = (k[1] == p[1]) & (k[2] == p[2]) & (k[6] == p[6])
    d = torch.zeros_like(k[7])
    for i in (0, 3, 4, 5):
        d = torch.maximum(d, (k[i] - p[i]).abs().amax(dim=0))
    d = torch.maximum(d, (k[7] - p[7]).abs())
    return {
        "frac_int_differ": float((~same).float().mean()),
        "frac_gt_1e-4": float((d > 1e-4).float().mean()),
        "max_abs": float(d[same].max()) if bool(same.any()) else math.inf,
    }


def phase_march_parity():
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48, approx_recip=False,
                              fused=False)
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.9)
    with torch.no_grad():
        args = _march_inputs(camera_rays_u(_camera(250, 141), m, a), m, a,
                             cfg, None)
        k = march_u(*args, cfg)
        p = march_u_plain(*args, cfg)
    torch.cuda.synchronize()
    s = march_compare(k, p)
    print(f"march kernel parity (250x141, 48 steps, a = 0.9): {s}")
    if not (s["frac_int_differ"] == 0.0 and s["max_abs"] < 1e-4):
        raise AssertionError(f"march kernel parity failed: {s}")

    out = {"short": s}
    for name, feats, p99_bar in (("analytic", Features(), 1e-4),
                                 ("spectral", Features(spectral_lut=True),
                                  2e-2)):
        fused = flagship_scene(480, 270, features=feats)
        staged = dataclasses.replace(fused, march_cfg=dataclasses.replace(
            FLAGSHIP_CFG, fused=False))
        march_u.launches = 0
        img = render_radiance(staged, device=DEV)
        torch.cuda.synchronize()
        launches = march_u.launches
        d = (img - render_radiance(fused, device=DEV)).abs()
        big = d.amax(dim=-1) > 1e-2
        st = {"p99_abs": float(torch.quantile(d.flatten().double(), 0.99)),
              "mean_abs": float(d.mean()),
              "frac_px_gt_1e-2": float(big.float().mean()),
              "mean_abs_rest": float(d[~big].mean()),
              "march_launches": launches}
        print(f"staged vs fused render ({name}, 480x270): {st}")
        if not (launches >= 1 and bool(torch.isfinite(img).all())
                and st["p99_abs"] < p99_bar
                and st["mean_abs"] < STAGED_MEAN_BAR
                and st["mean_abs_rest"] < STAGED_MEAN_REST_BAR):
            raise AssertionError(f"staged render failed ({name}): {st}")
        out[name] = st
    out["lut"] = lut_route_check()
    return out


def lut_route_check():
    """A staged spectral scene from ``Scene.create`` (no Chebyshev tables:
    its disk shades from the LUTs) rendered on the card through the march
    kernel against the same scene's plain render on the CPU, at the
    analytic bars (p99 |d| < 1e-4, mean < 1e-5); a second frame finds its
    tables on the card (``disk_luts``'s cache), so it copies none."""
    scene = flagship_scene(96, 54, cfg=dataclasses.replace(
        FLAGSHIP_CFG, max_steps=48, approx_recip=False, fused=False))
    if scene.spectral_coeffs is not None:
        raise AssertionError("a staged spectral scene carries Chebyshev "
                             "tables")
    march_u.launches = 0
    img = render_radiance(scene, device=DEV)
    hits = disk_luts.cache_info().hits
    render_radiance(scene, device=DEV)
    torch.cuda.synchronize()
    st = {"march_launches": march_u.launches,
          "cache_hits": disk_luts.cache_info().hits - hits}
    d = (img.cpu() - render_radiance(scene, device="cpu")).abs()
    st.update(p99_abs=float(torch.quantile(d.flatten().double(), 0.99)),
              mean_abs=float(d.mean()), max_abs=float(d.max()))
    print(f"staged spectral render on the LUT route (96x54, 48 steps), card "
          f"vs CPU plain: {st}")
    if not (st["march_launches"] == 2 and st["cache_hits"] >= 1
            and bool(torch.isfinite(img).all()) and st["p99_abs"] < 1e-4
            and st["mean_abs"] < 1e-5):
        raise AssertionError(f"LUT route on the card failed: {st}")
    return st


# tests/test_grad_kernel.py's scene and march configuration.
GRAD_CFG = MarchConfig(max_steps=48, shadow_precull=False, remat_every=0)


def _grad_loss(rows):
    """tests/test_grad_kernel.py's loss over every differentiable output."""
    return (rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()
            + 0.05 * rows.cross_phi.mean() + 0.02 * rows.cross_t.mean()
            + 0.01 * torch.exp(-rows.r_min_ph).mean())


def _march_rows(rays, m, a, cfg, kernel):
    """march_rows_ad (both kernels) or the plain march, by autograd."""
    if kernel:
        return march_rows_ad(rays, m, a, cfg)
    return MarchRows(*march_u_plain(*_march_inputs(rays, m, a, cfg, None),
                                    cfg))


def _param_grads(spin, kernel, mass=1.0, **over):
    cfg = dataclasses.replace(GRAD_CFG, **over)
    m, a = _cuda_scalar(mass, True), _cuda_scalar(spin, True)
    rows = _march_rows(camera_rays_u(_camera(48, 32), m, a), m, a, cfg, kernel)
    g_a, g_m = torch.autograd.grad(_grad_loss(rows), (a, m))
    return float(g_a), float(g_m)


def phase_grad_parity():
    out = {}
    for spin in (0.3, 0.9):
        g, ref = _param_grads(spin, True)[0], _param_grads(spin, False)[0]
        out[f"dspin_a{spin}"] = (g, ref, _rel(g, ref))
        if not (math.isfinite(g) and _rel(g, ref) < 5e-3):
            raise AssertionError(f"d/d(spin) at a = {spin}: {g} vs {ref}")
    g, ref = _param_grads(0.6, True)[1], _param_grads(0.6, False)[1]
    out["dmass_a0.6"] = (g, ref, _rel(g, ref))
    if not (math.isfinite(g) and _rel(g, ref) < 2e-2):
        raise AssertionError(f"d/d(mass): {g} vs {ref}")
    g, ref = (_param_grads(0.9, k, cotangent_clip=0.05)[0]
              for k in (True, False))
    out["dspin_clip0.05"] = (g, ref, _rel(g, ref))
    if not (math.isfinite(g) and _rel(g, ref) < 2e-2
            and abs(g - out["dspin_a0.9"][0]) > 1e-9):
        raise AssertionError(f"d/d(spin) with the clip: {g} vs {ref}")

    m, a = _cuda_scalar(1.0), _cuda_scalar(0.7)
    rays = camera_rays_u(_camera(48, 32), m, a)
    ct = []
    for kernel in (True, False):
        r = rays.clone().requires_grad_()
        rows = _march_rows(r, m, a, GRAD_CFG, kernel)
        loss = rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()
        ct.append(torch.autograd.grad(loss, r)[0])
    d = (ct[0] - ct[1]).abs() / (ct[1].abs() + 1e-6)
    p95 = float(torch.quantile(d.flatten().double(), 0.95))
    out["ray_cotangent_p95_rel"] = p95
    print(f"gradient kernel vs autograd through the plain march: {out}")
    if not (bool(torch.isfinite(ct[0]).all()) and p95 < 1e-2):
        raise AssertionError(f"per-ray cotangents: p95 rel {p95}")
    return out


def grad_compare(k, p):
    """Gradient kernel vs plain: the 95th percentile of the relative
    difference of the initial-row cotangents; the tail of each ray's worst
    row (99.9th percentile, share above 1e-3, largest); their largest |d|;
    and the relative difference of each summed (m, a, r_h, r_ph) partial."""
    rows = [0, 1, 2, 3, 5, 6, 7]
    d = (k[0][rows] - p[0][rows]).abs()
    rel = d / (p[0][rows].abs() + 1e-6)
    ray_rel = rel.amax(dim=0).double()   # each ray's worst row
    return {
        "ray_p95_rel": float(torch.quantile(
            rel.flatten().double(), 0.95)),
        "ray_p999_rel": float(torch.quantile(ray_rel, 0.999)),
        "frac_rel_gt_1e-3": float((ray_rel > 1e-3).double().mean()),
        "max_rel": float(ray_rel.max()),
        "max_abs": float(d.max()),
        "finite": bool(torch.isfinite(k[0]).all())
        and all(math.isfinite(float(x)) for x in k[1:]),
        "partials": [float(x) for x in k[1:]],
        "partials_plain": [float(x) for x in p[1:]],
        "partials_rel": [_rel(float(x), float(y))
                         for x, y in zip(k[1:], p[1:])],
    }


def _step_ref64(chk, yt0, thr, m, a, r_h, r_ph, cfg, cts):
    """float64 autograd through the plain step (march_step_rows) at every
    live step of a per-step check, from its recorded pre-step states, with
    the check's cotangent injection: (11, steps, N), NaN where no step
    ran."""
    state, live = chk["state"], chk["live"]
    steps, n = live.shape
    out = torch.full((11, steps, n), math.nan, dtype=torch.float64,
                     device=DEV)
    scalars = [torch.as_tensor(v).detach().double().to(DEV)
               for v in (m, a, r_h, r_ph)]
    for i in range(steps):
        sel = live[i]
        k = int(sel.sum())
        if k == 0:
            continue
        st = state[:, i, sel].double()
        ins = [st[q].clone().requires_grad_() for q in range(6)]
        ins += [yt0[7][sel].double().requires_grad_()]
        ins += [v.expand(k).clone().requires_grad_() for v in scalars]
        hit = torch.full((k,), HIT_NONE, dtype=torch.int32, device=DEV)
        with torch.enable_grad():
            (y2, r_c, phi_c, t_c, dmin, _), (_, _, crossed, advance) = (
                march_step_rows(ins[7], ins[8], ins[9], ins[10],
                                thr[sel].double(), cfg, i, tuple(ins[:6]),
                                ins[6], hit, st[6].to(torch.int32)))
            ct = cts[:, sel].double()
            cto = [*ct[:6], *(torch.where(crossed, c, 0.0) for c in ct[6:9]),
                   torch.where(advance, ct[9], 0.0)]
            g = torch.autograd.grad([*y2, r_c, phi_c, t_c, dmin], ins, cto,
                                    allow_unused=True)
        out[:, i, sel] = torch.stack(
            [torch.zeros(k, dtype=torch.float64, device=DEV) if x is None
             else x for x in g])
    return out


def _element(idx, cfg, e, **rows):
    """One element of a per-step check's live rows, for the report."""
    k, col = divmod(int(e), int(idx.shape[0]))
    i, j = (int(x) for x in idx[col])
    return {"input": STEP_INPUTS[k], "step": i, "ray": j,
            "renormalized": (i + 1) % cfg.renormalize_every == 0,
            **{name: float(v[k, col]) for name, v in rows.items()}}


def step_check(g_args):
    """The gradient kernel's per-step adjoint against the dual pass on the
    card (csrc/step_vjp_check.cu), on a seeded sample of the recorded step's
    rays at every live step, with seeded unit cotangents, approx_recip on
    and off. The relative difference (floored as grad_compare's): its 99th
    percentile, the share above 1e-3 and the largest; the largest
    difference over the size of the derivative's terms; and, to say how
    near each route is to the true derivative, both against float64
    autograd through the plain step at the recorded states (99th
    percentile and largest). The worst element of the relative difference,
    of the size ratio and of the adjoint against float64, with its input,
    step, ray, both values, the float64 one and the terms' size (a size far
    above |value| is a cancellation)."""
    yt0, thr, m, a, r_h, r_ph, cfg = g_args[:7]
    gen = torch.Generator(device=DEV).manual_seed(5)
    n = int(yt0.shape[1])
    pick = torch.randperm(n, generator=gen, device=DEV)[:STEP_CHECK_RAYS]
    cts = torch.randn((10, len(pick)), generator=gen, device=DEV)
    # (kthvalue: torch.quantile takes at most 2**24 elements)
    q99 = lambda x: float(x.kthvalue(max(1, math.ceil(0.99 * x.numel())))
                          .values)
    out = {}
    for approx in (True, False):
        c = dataclasses.replace(cfg, approx_recip=approx)
        args = (yt0[:, pick], thr[pick], m, a, r_h, r_ph, c)
        chk = step_vjp_check(*args, cts, cfg.max_steps)
        torch.cuda.synchronize()
        live = chk["live"]
        idx = live.nonzero()
        adj, dual, size = (chk[k][:, live] for k in ("adjoint", "dual",
                                                     "size"))
        diff = (adj - dual).abs()
        rel = diff / (dual.abs() + 1e-6)
        by_size = torch.where(diff > 0, diff / size, 0.0)
        finite = bool(torch.isfinite(adj).all() and torch.isfinite(dual).all())
        ref = _step_ref64(chk, *args, cts)[:, live]
        ok_ref = torch.isfinite(ref)
        ref_rel = lambda v: torch.where(
            ok_ref, (v.double() - ref).abs() / (ref.abs() + 1e-6),
            0.0).flatten()
        rows = dict(adjoint=adj, dual=dual, float64=ref, size=size)
        st = {"rays": len(pick), "live_steps": int(live.sum()),
              "p99_rel": q99(rel.flatten()) if finite else math.nan,
              "frac_rel_gt_1e-3": float((rel > 1e-3).double().mean()),
              "max_rel": float(rel.max()), "finite": finite,
              "max_diff_over_size": float(by_size.max()),
              "ref_nonfinite": int((~ok_ref).sum()),
              "adjoint_vs_f64_p99_max": [q99(ref_rel(adj)),
                                         float(ref_rel(adj).max())],
              "dual_vs_f64_p99_max": [q99(ref_rel(dual)),
                                      float(ref_rel(dual).max())],
              "worst_rel": _element(idx, cfg, rel.argmax(), **rows),
              "worst_over_size": _element(idx, cfg, by_size.argmax(),
                                          **rows),
              "worst_vs_f64": _element(idx, cfg, ref_rel(adj).argmax(),
                                       **rows)}
        print(f"per-step adjoint vs dual pass (approx_recip={approx}): {st}")
        if not (finite and st["p99_rel"] <= STEP_CHECK_P99_BAR
                and st["frac_rel_gt_1e-3"] <= STEP_CHECK_TAIL_BAR
                and st["max_diff_over_size"] <= STEP_CHECK_SIZE_BAR):
            raise AssertionError(f"per-step adjoint vs dual failed: {st}")
        out[f"approx_{approx}"] = st
    return out


def mirror_check(g_args):
    """The adjoint's CPU mirror (ops/march_adjoint.py) against the header
    it mirrors, on MIRROR_CHECK_RAYS of the recorded step's rays at every
    live step, exact divides: the mirror runs on the check's recorded
    states and must equal the kernel's adjoint bit for bit."""
    yt0, thr, m, a, r_h, r_ph, cfg = g_args[:7]
    cfg = dataclasses.replace(cfg, approx_recip=False)
    gen = torch.Generator(device=DEV).manual_seed(6)
    pick = torch.randperm(int(yt0.shape[1]), generator=gen,
                          device=DEV)[:MIRROR_CHECK_RAYS]
    cts = torch.randn((10, len(pick)), generator=gen, device=DEV)
    args = (yt0[:, pick], thr[pick], m, a, r_h, r_ph, cfg)
    chk = step_vjp_check(*args, cts, cfg.max_steps)
    live = chk["live"].cpu()
    got = chk["adjoint"].cpu()[:, live]
    want = march_step_vjp_at(chk, *args, cts)[:, live]
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    st = {"rays": len(pick), "elements": int(same.numel()),
          "not_bit_equal": int((~same).sum()),
          "max_abs": float((got - want).abs().max())}
    print(f"adjoint mirror (CPU) vs header (card), exact divides: {st}")
    if st["not_bit_equal"]:
        raise AssertionError(f"adjoint mirror differs from the header: {st}")
    return st


def replay_check(m_args, g_args):
    """The gradient kernel's replay against the forward march on the
    recorded training step's rays (approx_recip on, the step's own route):
    every ray's hit, live steps and crossing count equal the march
    kernel's."""
    n = int(m_args[0].shape[1])
    replay = torch.empty((3, n), dtype=torch.int32, device=DEV)
    with torch.no_grad():
        fwd = march_u(*m_args)
        march_grad_kernel(*g_args, replay=replay)
    torch.cuda.synchronize()
    st = {"rays": n, "approx_recip": bool(m_args[6].approx_recip)}
    for i, (name, k) in enumerate((("hit", 1), ("steps", 2), ("nc", 6))):
        st[f"{name}_differ"] = int((replay[i] != fwd[k]).sum())
    print(f"gradient kernel's replay vs the march kernel (1080p training "
          f"rays): {st}")
    if not (st["approx_recip"] and st["hit_differ"] == 0
            and st["steps_differ"] == 0 and st["nc_differ"] == 0):
        raise AssertionError(f"replay differs from the forward march: {st}")
    return st


def renorm_check():
    """The renormalization's VJP alone at planted radial turning points
    (ops/march_adjoint.py::turning_point_states, csrc/step_vjp_check.cu):
    the hand-written adjoint
    against ks_renormalize_pr on Dual<7> (the same float32 discriminant, so
    the same branch), each state's largest difference over its largest
    |dual| cotangent <= RENORM_CHECK_BAR, all finite; at the exact double
    root, the adjoint against float64 autograd through the plain
    ks_renormalize_pr (rel 1e-5). A tie rule applied to the floored
    discriminant fails here: it sends the double root's discriminant half
    of 0.5 / sqrt(1e-30)."""
    q = turning_point_states(device=DEV)
    adj, dual = renorm_vjp_check(q)
    disc = renorm_discriminant(q)
    ins = [x.double().clone().requires_grad_() for x in q[:7, :1]]
    with torch.enable_grad():
        out = ks_renormalize_pr(ins[0], ins[1], ins[2], ins[3],
                                torch.full_like(ins[0], -1.0), ins[4], ins[5],
                                ins[6])
        ref = torch.autograd.grad(out, ins, q[7, :1].double(),
                                  allow_unused=True)
    ref = torch.stack([torch.zeros(1, dtype=torch.float64, device=DEV)
                       if x is None else x for x in ref])[:, 0]
    rel = ((adj - dual).abs().amax(0)
           / dual.abs().amax(0).clamp_min(1e-30))
    root_rel = max(_rel(float(x), float(y)) for x, y in zip(adj[:, 0], ref))
    st = {"states": int(q.shape[1]),
          "disc_zero": int((disc == 0).sum()),
          "disc_negative": int((disc < 0).sum()),
          "disc_below_1e-4": int(((disc > 0) & (disc < 1e-4)).sum()),
          "finite": bool(torch.isfinite(adj).all()
                         and torch.isfinite(dual).all()),
          "max_rel": float(rel.max()), "double_root_vs_f64_rel": root_rel,
          "double_root_adjoint": [float(x) for x in adj[:, 0]]}
    print(f"renormalization adjoint vs dual at turning points: {st}")
    if not (st["finite"] and st["max_rel"] <= RENORM_CHECK_BAR
            and root_rel <= 1e-5 and st["disc_zero"] >= 1):
        raise AssertionError(f"renormalization adjoint failed: {st}")
    return st


def phase_train(steps=5, warmup=2, width=1920, height=1080):
    scene = flagship_scene(width, height, cfg=TRAIN_CFG, features=Features())
    cfg = scene.march_cfg
    params = InverseParams.init(spin=0.9, theta_cam=float(scene.camera.theta),
                                device=DEV)
    target = torch.zeros((height, width, 3), device=DEV)
    step = make_inverse_step(scene, device=DEV)
    for i in range(warmup):
        if i == warmup - 1:   # keep the kernels' arguments of one real step
            march_u.record, march_grad_kernel.record = [], []
        step(params, target)
    m_args, g_args = march_u.record[0], march_grad_kernel.record[0]
    march_u.record = march_grad_kernel.record = None
    RECORDED["midpoint"] = m_args
    RECORDED["training"] = (m_args, g_args)
    torch.cuda.synchronize()

    results = []
    march_u.launches = 0
    march_grad_kernel.launches = 0
    step_ms, step_min, step_max = timed(
        lambda: results.append(step(params, target)), steps)
    launches = {"march": march_u.launches,
                "march_grad": march_grad_kernel.launches}
    (p1, (m1, v1, t1)), loss = results[-1]
    grads = [float(x) / 0.1 for x in m1.leaves()]   # m = (1 - b1) g
    if min(launches.values()) < steps:
        raise AssertionError(f"kernel launches in {steps} steps: {launches}")
    if not all(math.isfinite(x) for x in [float(loss), *grads,
                                          *map(float, p1.leaves())]):
        raise AssertionError(f"training step not finite: loss {loss}, "
                             f"clipped gradients {grads}")
    scratch = march_grad_kernel.scratch_bytes
    n_pix = width * height

    # Each kernel alone on the recorded step's own arguments, then against
    # its plain version there at exact divides.
    march_ms, outs = kernel_time(lambda: march_u(*m_args), 20)
    n_rays = int(outs[0].shape[1])
    total_steps = int(outs[2].long().sum())

    cfg_x = dataclasses.replace(cfg, approx_recip=False)
    with torch.no_grad():
        k = march_u(*m_args[:6], cfg_x)
        t0 = time.perf_counter()
        p = march_u_plain(*m_args[:6], cfg_x)
        torch.cuda.synchronize()
        march_plain_ms = (time.perf_counter() - t0) * 1e3
    ms = march_compare(k, p)
    print(f"1080p march kernel vs plain (step inputs, exact divides): {ms}")
    if not (ms["frac_int_differ"] < 1e-3 and ms["frac_gt_1e-4"] < 1e-3):
        raise AssertionError(f"1080p march kernel vs plain failed: {ms}")
    gs, grad_e = grad_entry("training step", launches["march_grad"], m_args,
                            g_args)
    print(f"1080p gradient kernel vs plain (step inputs, exact divides): {gs}")
    parent_gate("training gradient", grad_e["ms"])

    checks = step_check(g_args)
    checks["forward_replay"] = replay_check(m_args, g_args)
    checks["renorm"] = renorm_check()
    checks["mirror"] = mirror_check(g_args)
    shape = grad_kernel_shape(cfg.approx_recip)
    regs, spill = registers("march_grad.cu", "ILb1ELb0E")
    print(f"gradient kernel occupancy: {shape['blocks_per_sm']} blocks of "
          f"{shape['threads']} threads = {shape['warps_per_sm']} resident "
          f"warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
          f"{regs} registers, {spill} bytes spilled, {shape['smem_bytes']} "
          "bytes of shared memory per block")

    k_slots = cfg.max_crossings
    march_ops = step_ops("midpoint", cfg.approx_recip) * total_steps
    march_bytes = 4 * n_rays * (9 + 8 + 3 + 3 * k_slots + 1)
    grad_ms = grad_e["ms"]
    print(f"training step {width}x{height}: {step_ms:.3f} ms/step median of {steps} "
          f"(min {step_min:.3f}, max {step_max:.3f}), "
          f"{n_pix / step_ms / 1e3:.2f} Mrays/s fwd+bwd; launches {launches}; "
          f"march {march_ms:.3f} ms, gradient {grad_ms:.3f} ms; scratch "
          f"{scratch} bytes; loss {float(loss):.6e}; clipped gradients "
          f"{grads}; steps/ray {total_steps / n_rays:.2f}")

    curriculum = phase_ad_curriculum()
    common = dict(route="cuda", library_ms=None, steps_per_ray=(
        total_steps / n_rays), rays=n_rays)
    march_bound, march_by = bound(march_ops, march_bytes)
    train = {
        "step_ms": step_ms, "step_ms_min_max": [step_min, step_max],
        "mrays_per_s": n_pix / step_ms / 1e3, "steps": steps,
        "loss": float(loss), "clipped_grads": grads, "scratch_bytes": scratch,
        "launches_per_step": {k: v / steps for k, v in launches.items()},
        "ad_curriculum": curriculum, "step_check": checks,
        "grad_occupancy": shape,
    }
    return train, [
        dict(name="march",
             source="blackhole_simulation_tpu_torch/csrc/march.cu",
             replaces="blackhole_simulation_tpu/ops/pallas_march.py:646",
             launches=launches["march"], max_abs_err=ms["max_abs"],
             ms=march_ms, plain_ms=march_plain_ms, bound_ms=march_bound,
             bound_by=march_by, frac_int_differ=ms["frac_int_differ"],
             path="training step", variant="midpoint",
             steps_sum=total_steps, steps_max=int(outs[2].max()),
             lane_efficiency_one_per_thread=lane_efficiency(outs[2]),
             resident_warps_per_sm=march_kernel_shape(cfg)["warps_per_sm"],
             **common),
        dict(grad_e, frac_rel_gt_1e3=gs["frac_rel_gt_1e-3"],
             max_rel=gs["max_rel"], partials_rel=gs["partials_rel"],
             scratch_bytes=scratch, registers_spill=[regs, spill],
             smem_bytes=shape["smem_bytes"],
             warps_per_sm=shape["warps_per_sm"], ckpt=shape["ckpt"],
             step_check=checks),
    ]


def phase_ad_curriculum():
    cam = _camera(256, 256)
    scene = Scene.create(
        mass=1.0, spin=0.85, camera=cam,
        march_cfg=MarchConfig(max_steps=256, step_rate=0.12,
                              far_step_cap_rate=0.4, far_boost_radius=20.0,
                              midpoint_iters=1, remat_every=32))
    target = render_radiance(scene, device=DEV)
    march_u.launches = 0
    march_grad_kernel.launches = 0
    t0 = time.perf_counter()
    params, losses = ad_inverse_render(
        scene, target, n_steps=36, stages=((64, 8), (96, 4)),
        init=InverseParams.init(spin=0.5, theta_cam=float(cam.theta)),
        device=DEV)
    secs = time.perf_counter() - t0
    spin = float(params.spin)
    out = {"seconds": secs, "first_loss": losses[0], "final_loss": losses[-1],
           "spin": spin, "launches": {"march": march_u.launches,
                                      "march_grad": march_grad_kernel.launches}}
    print(f"ad_inverse_render 256x256, 36 steps: {out}")
    if not (losses[-1] < 0.1 * losses[0] and abs(spin - 0.85) < 1e-2
            and march_grad_kernel.launches >= 36):
        raise AssertionError(f"AD curriculum did not converge: {out}")
    return out


def march_entry(name_note, launches, args, plain_args, ops_per_step, **extra):
    """A kernels-line entry for a march-kernel launch: the kernel alone on
    ``args`` (CUDA events), its plain version once on ``plain_args``, the
    comparison, and the bound from this run's steps."""
    with torch.no_grad():
        ms, out = kernel_time(lambda: march_u(*args), 20)
        k = out if plain_args is args else march_u(*plain_args)
        t0 = time.perf_counter()
        p = march_u_plain(*plain_args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    cmp = march_compare(k, p)
    n_rays = int(out[0].shape[1])
    steps = out[2].long()
    k_slots = args[6].max_crossings
    bound_ms, bound_by = bound(ops_per_step * int(steps.sum()),
                               4 * n_rays * (9 + 8 + 3 + 3 * k_slots + 1))
    return cmp, dict(
        name="march", route="cuda",
        source="blackhole_simulation_tpu_torch/csrc/march.cu",
        replaces="blackhole_simulation_tpu/ops/pallas_march.py:646",
        path=name_note, launches=launches, max_abs_err=cmp["max_abs"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, rays=n_rays,
        steps_sum=int(steps.sum()), steps_max=int(steps.max()),
        steps_per_ray=float(steps.float().mean()),
        lane_efficiency_one_per_thread=lane_efficiency(steps),
        resident_warps_per_sm=march_kernel_shape(
            args[6], args[7] if len(args) > 7 else None)["warps_per_sm"],
        frac_int_differ=cmp["frac_int_differ"], **extra)


# The march kernel's arguments on the 1080p paths, by march variant (the
# training step's midpoint march, the staged AB3 and jets renders' and the
# certified render's refinement re-march), kept for phase 12's probes.
RECORDED = {}
# Phase 12's uniform-ray probe: copies of one ray, as many as a 1080p frame
# has pixels.
PROBE_RAYS = 1920 * 1080


def uniform_probe(args):
    """The march kernel on PROBE_RAYS copies of one ray of ``args``, for
    the ray nearest the median step count and for the longest: no lane
    waits on another, so ms / (steps x rays) is what one ray-step costs at
    full occupancy."""
    yt0, thr, *rest = args
    with torch.no_grad():
        steps = march_u(*args)[2]
    med = steps.float().median()
    out = {}
    for name, j in (("median", int((steps.float() - med).abs().argmin())),
                    ("longest", int(steps.argmax()))):
        y = yt0[:, j:j + 1].expand(8, PROBE_RAYS).contiguous()
        t = thr[j:j + 1].expand(PROBE_RAYS).contiguous()
        with torch.no_grad():
            ms, o = kernel_time(lambda: march_u(y, t, *rest), 10)
        n_steps = int(o[2][0])
        if not bool((o[2] == n_steps).all()):
            raise AssertionError("uniform probe: copies of one ray took "
                                 "different step counts")
        out[name] = {"ray": j, "steps": n_steps, "ms": ms,
                     "ns_per_ray_step": ms * 1e6 / (n_steps * PROBE_RAYS)}
    return out


def render_uniform_probe():
    """The render kernel on a 1080p frame whose pixels all march one ray
    (fov 1e-7: every camera ray is the view axis to float precision;
    precull off, so each marches to the horizon), midpoint and AB3, on both
    routes: ms / (sum of steps) is what one of render.cu's own ray-steps
    costs, with the per-pixel birth and composite spread over it."""
    out = {}
    for approx in (True, False):
        route = "approx" if approx else "exact"
        for name, multistep in (("midpoint", False), ("ab3", True)):
            cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=1e-7,
                                width=1920, height=1080)
            cfg = dataclasses.replace(FLAGSHIP_CFG, shadow_precull=False,
                                      multistep=multistep,
                                      approx_recip=approx)
            scene = Scene.create(mass=1.0, spin=0.999, camera=cam,
                                 march_cfg=cfg, features=Features())
            row, st = kernel_inputs(scene, None, DEV)
            steps = torch.empty((st.height, st.width), dtype=torch.int32,
                                device=DEV)
            render_planes_kernel(row, st, steps)
            ms, _ = kernel_time(lambda: render_planes_kernel(row, st), 20)
            total = int(steps.long().sum())
            out[f"{name}_{route}"] = {
                "ms": ms, "steps_sum": total,
                "steps_min_max": [int(steps.min()), int(steps.max())],
                "ns_per_ray_step": ms * 1e6 / total}
        out[f"ab3_over_midpoint_{route}"] = (
            out[f"ab3_{route}"]["ns_per_ray_step"]
            / out[f"midpoint_{route}"]["ns_per_ray_step"])
    return out


def critical_path(args):
    """The march kernel alone on the longest ray of ``args``, and on 32
    copies of it (one warp): the least time any schedule that marches one
    ray per thread can take for the whole launch."""
    yt0, thr, *rest = args
    with torch.no_grad():
        steps = march_u(*args)[2]
    j = int(steps.argmax())
    out = {"ray": j, "steps": int(steps[j])}
    for copies in (1, 32):
        y = yt0[:, j:j + 1].expand(8, copies).contiguous()
        t = thr[j:j + 1].expand(copies).contiguous()
        with torch.no_grad():
            out[f"ms_{copies}"], _ = kernel_time(
                lambda: march_u(y, t, *rest), 10)
    return out


def instantiation_shapes():
    """Registers, spill bytes and resident warps per SM of every
    instantiation of the render kernel (MARCH x EXTRAS x APPROX) and the
    march kernel (MARCH x APPROX), from ptxas and the occupancy API."""
    out = {}
    for approx in (True, False):
        cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48,
                                  approx_recip=approx)
        ab3 = dataclasses.replace(cfg, multistep=True)
        a = int(approx)
        render_cases = {
            f"ILi0ELb0ELb{a}E": flagship_scene(16, 8, cfg=cfg),
            f"ILi1ELb0ELb{a}E": flagship_scene(16, 8, cfg=ab3),
            f"ILi2ELb0ELb{a}E": branch_scene("jets", 16, 8, cfg),
            f"ILi0ELb1ELb{a}E": branch_scene("overlay", 16, 8, cfg),
            f"ILi1ELb1ELb{a}E": branch_scene("overlay", 16, 8, ab3),
            f"ILi2ELb1ELb{a}E": branch_scene("all", 16, 8, cfg),
        }
        for marker, scene in render_cases.items():
            _, st = kernel_inputs(scene, None, DEV)
            out[f"render {marker}"] = [
                *registers("render.cu", marker),
                render_kernel_shape(st)["warps_per_sm"]]
        for marker, c, jets in ((f"ILi0ELb{a}E", cfg, None),
                                (f"ILi1ELb{a}E", ab3, None),
                                (f"ILi2ELb{a}E", cfg, JetParams())):
            out[f"march {marker}"] = [
                *registers("march.cu", marker),
                march_kernel_shape(c, jets)["warps_per_sm"]]
    print(f"instantiations (registers, spill bytes, resident warps per SM):"
          f" {json.dumps(out)}")
    spilled = {k: v for k, v in out.items() if v[1]}
    if spilled:
        raise AssertionError(f"instantiations that spill: {spilled}")
    return out


def phase_probes(entries):
    """Phase 12: what holds the render and march kernels back on each
    1080p path. For each march variant the uniform-ray probe's cost of one
    ray-step; for each path its lane efficiency (``lane_efficiency`` of its
    step counts grouped into warps of one ray per thread: the render
    kernel's own launch, the launch the march kernel's persistent loop
    replaced), that cost x its steps and its bound; and the refinement
    re-march's critical path. Adds them to the kernels-line entries: a
    march path's ``no_divergence_ms`` (the same kernel without waiting
    lanes), a render path's ``steps_at_march_step_cost_ms`` (its steps at
    the persistent march loop's cost per step, which is not render.cu's
    loop; its per-pixel work left out)."""
    probes = {v: uniform_probe(RECORDED[v])
              for v in ("midpoint", "ab3", "jets")}
    crit = critical_path(RECORDED["refinement"])
    shapes = instantiation_shapes()
    rprobe = render_uniform_probe()
    per_step = {v: probes[v]["median"]["ns_per_ray_step"] for v in probes}
    probes["ab3_over_midpoint"] = per_step["ab3"] / per_step["midpoint"]
    print(f"uniform-ray probe (march kernel, {PROBE_RAYS} copies of one "
          f"ray): {json.dumps(probes)}")
    print(f"uniform-ray probe (render kernel, one ray in every pixel of a "
          f"1080p frame): {json.dumps(rprobe)}")
    print(f"refinement re-march critical path: {json.dumps(crit)}")
    for e in entries:
        if "variant" not in e:
            continue
        cost = probes[e["variant"]]["median"]["ns_per_ray_step"]
        e["uniform_ns_per_ray_step"] = cost
        march = e["name"] == "march"
        eff = e["lane_efficiency_one_per_thread" if march
                else "lane_efficiency"]
        stepped = cost * e["steps_sum"] * 1e-6
        e["no_divergence_ms" if march
          else "steps_at_march_step_cost_ms"] = stepped
        if e["path"].endswith("refinement re-march"):
            e["critical_path_ms"] = crit["ms_1"]
            e["critical_path_32_ms"] = crit["ms_32"]
        print(f"{e['name']} kernel, {e['path']}: {e['ms']:.4f} ms; lane "
              f"efficiency (one ray per thread) {eff:.4f}; steps at the "
              f"march kernel's uniform cost {stepped:.4f} ms; bound "
              f"{e['bound_ms']:.4f} ms;"
              f" steps {e['steps_sum']} (max {e['steps_max']}); resident "
              f"warps per SM {e['resident_warps_per_sm']}"
              + (f"; critical path {crit['ms_1']:.4f} ms"
                 if "critical_path_ms" in e else ""))
    return {"uniform": probes, "render_uniform": rprobe,
            "critical_path": crit, "instantiations": shapes}


# Phase 11: small and ragged launches: one ray, fewer than a warp, fewer
# than the march kernel's resident lanes, a ragged frame.
POOL_FRAMES = ((1, 1), (31, 1), (128, 128), (250, 141))
POOL_RAYS = (1, 31, 16384, 250 * 141)


def same_bits(a, b):
    """Bitwise equality of two tensors (NaN equal to the same NaN)."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def sentinel_render(row, st):
    """Two launches of the render kernel into planes and steps pre-filled
    with different sentinels (NaN / -1, then 7 / 12345): every element
    written by one launch gives two bitwise-equal results."""
    outs = []
    for fill, ifill in ((math.nan, -1), (7.0, 12345)):
        n_planes = 4 if st.cfg.refine_band > 0.0 else 3
        out = torch.full((n_planes, st.height, st.width), fill, device=DEV)
        steps = torch.full((st.height, st.width), ifill, dtype=torch.int32,
                           device=DEV)
        render_planes_kernel(row, st, steps, out=out)
        outs.append((out, steps))
    torch.cuda.synchronize()
    (o1, s1), (o2, s2) = outs
    return same_bits(o1, o2) and same_bits(s1, s2)


def sentinel_march(args):
    """The march kernel's twin of ``sentinel_render``, on all nine outputs,
    and its ray pool back at zero after each launch."""
    outs = []
    n = int(args[0].shape[1])
    k_slots = args[6].max_crossings
    shapes = ((8, n), (n,), (n,), (k_slots, n), (k_slots, n), (k_slots, n),
              (n,), (n,), (3, n))
    ints = (1, 2, 6)
    for fill, ifill in ((math.nan, -1), (7.0, 12345)):
        out = tuple(torch.full(sh, ifill, dtype=torch.int32, device=DEV)
                    if i in ints else torch.full(sh, fill, device=DEV)
                    for i, sh in enumerate(shapes))
        with torch.no_grad():
            march_u(*args, out=out)
        outs.append((out, ray_pool(DEV).clone()))
    torch.cuda.synchronize()
    (o1, p1), (o2, p2) = outs
    return (all(same_bits(a, b) for a, b in zip(o1, o2))
            and not bool(p1.any()) and not bool(p2.any()))


def phase_edges():
    """Phase 11: the render kernel (midpoint, AB3, every branch with jets)
    at 1x1, 31x1, 128x128 (16,384 pixels, fewer than the resident grid's
    lanes) and a ragged 250x141, and the march kernel (midpoint, AB3, jets)
    on the first 1, 31, 16,384 and 35,250 of the 250x141 camera rays, each
    against its plain version (48 steps, exact divides, a = 0.9): step
    counts identical (and hit and crossing counts for the march), the
    floats at phase 2's and phase 5's bars; and each launch's outputs fully
    written (``sentinel_render``, ``sentinel_march``)."""
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48, approx_recip=False)
    scenes = {
        "midpoint": lambda w, h: flagship_scene(w, h, spin=0.9, cfg=cfg,
                                                features=Features()),
        "ab3": lambda w, h: flagship_scene(
            w, h, spin=0.9, cfg=dataclasses.replace(cfg, multistep=True),
            features=Features(spectral_lut=True)),
        "all": lambda w, h: branch_scene("all", w, h, cfg),
    }
    out = {}
    for name, make in scenes.items():
        for w, h in POOL_FRAMES:
            row, st = kernel_inputs(make(w, h), None, DEV)
            sk = torch.empty((h, w), dtype=torch.int32, device=DEV)
            sp = torch.empty((h, w), dtype=torch.int32, device=DEV)
            d = diff_stats(render_planes_kernel(row, st, sk),
                           render_planes(row, st, sp))
            d["steps_equal"] = bool(torch.equal(sk, sp))
            d["sentinel"] = sentinel_render(row, st)
            key = f"render_{name}_{w}x{h}"
            print(f"edges, {key}: {d}")
            if not (d["steps_equal"] and d["sentinel"]
                    and d["p99_abs"] < 1e-4 and d["mean_abs"] < 1e-5):
                raise AssertionError(f"edges {key}: {d}")
            out[key] = d
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.9)
    mcfg = dataclasses.replace(cfg, fused=False, shadow_precull=False)
    with torch.no_grad():
        rays = _march_inputs(camera_rays_u(_camera(250, 141), m, a), m, a,
                             mcfg, None)
    for name, c, jets in (
            ("midpoint", mcfg, None),
            ("ab3", dataclasses.replace(mcfg, multistep=True), None),
            ("jets", mcfg, JetParams())):
        for n in POOL_RAYS:
            args = (rays[0][:, :n].contiguous(), rays[1][:n].contiguous(),
                    *rays[2:6], c, jets)
            with torch.no_grad():
                k, p = march_u(*args), march_u_plain(*args)
            s = march_compare(k, p)
            if jets is not None:
                s["jet_rel"] = float(((k[8] - p[8]).abs()
                                      / (p[8].abs() + 1e-12)).max())
            s["sentinel"] = sentinel_march(args)
            key = f"march_{name}_{n}"
            print(f"edges, {key}: {s}")
            if not (s["frac_int_differ"] == 0.0 and s["max_abs"] < 1e-4
                    and s["sentinel"] and s.get("jet_rel", 0.0) < 1e-5):
                raise AssertionError(f"edges {key}: {s}")
            out[key] = s
    return out


def phase_ab3(flagship):
    """Phase 8: the AB3 march in both forward kernels."""
    ab3 = dataclasses.replace(FLAGSHIP_CFG, multistep=True)
    # The march kernel against its plain version.
    cfg = dataclasses.replace(ab3, max_steps=48, approx_recip=False,
                              fused=False)
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.9)
    with torch.no_grad():
        args = _march_inputs(camera_rays_u(_camera(250, 141), m, a), m, a,
                             cfg, None)
        s = march_compare(march_u(*args, cfg), march_u_plain(*args, cfg))
    print(f"AB3 march kernel parity (250x141, 48 steps, a = 0.9): {s}")
    if not (s["frac_int_differ"] == 0.0 and s["max_abs"] < 1e-4):
        raise AssertionError(f"AB3 march kernel parity failed: {s}")
    out = {"march_short": s}
    # The render kernel against its plain version.
    cfg = dataclasses.replace(ab3, max_steps=48, approx_recip=False)
    for name, feats in (("analytic", Features()),
                        ("spectral", Features(spectral_lut=True))):
        row, st = kernel_inputs(flagship_scene(250, 141, spin=0.9, cfg=cfg,
                                               features=feats), None, DEV)
        d = diff_stats(render_planes_kernel(row, st), render_planes(row, st))
        print(f"AB3 render kernel parity ({name}, 250x141, 48 steps): {d}")
        if not (d["p99_abs"] < 1e-4 and d["mean_abs"] < 1e-5):
            raise AssertionError(f"AB3 render kernel parity failed: {d}")
        out[f"render_short_{name}"] = d
    # tests/test_ab3.py's structural bars against the midpoint render.
    cfg = MarchConfig(max_steps=96, use_pallas=True, fused=True,
                      multistep=True)
    sa = flagship_scene(480, 270, spin=0.9, cfg=cfg, features=Features())
    sb = dataclasses.replace(sa, march_cfg=dataclasses.replace(
        cfg, multistep=False))
    ia, ib = render_radiance(sa, device=DEV), render_radiance(sb, device=DEV)
    d = (ia - ib).abs()
    st = {"median_abs": float(d.median()),
          "frac_lt_0.3": float((d < 0.3).float().mean())}
    print(f"AB3 vs midpoint render (480x270, 96 steps, a = 0.9): {st}")
    if not (bool(torch.isfinite(ia).all()) and st["median_abs"] < 5e-3
            and st["frac_lt_0.3"] > 0.95):
        raise AssertionError(f"AB3 structural bars failed: {st}")
    out["structural"] = st

    # The flagship render() at 1080p with the AB3 march.
    width, height = 1920, 1080
    n_pix = width * height
    scene = flagship_scene(width, height, cfg=ab3)
    (frame_ms, frame_min, frame_max), launches = render_frames(scene)
    regs = registers("render.cu", "ILi1ELb0ELb1E")
    render_entry, d, _, _ = render_kernel_entry(
        scene, launches["render"], step_ops("ab3", True), OPS_PER_PIXEL, 12,
        "blackhole_simulation_tpu/ops/pallas_march.py:428",
        path="flagship render() with multistep (AB3)", variant="ab3",
        frame_ms=frame_ms,
        frame_ms_min_max=[frame_min, frame_max],
        mrays_per_s=n_pix / frame_ms / 1e3, registers_spill=list(regs),
        midpoint_frame_ms=flagship["frame_ms"],
        midpoint_kernel_ms=flagship["ms"],
        midpoint_steps_per_ray=flagship["steps_per_ray"])
    print(f"AB3 flagship render() 1920x1080: {frame_ms:.3f} ms/frame median of"
          f" 30 (midpoint {flagship['frame_ms']:.3f}); kernel "
          f"{render_entry['ms']:.3f} ms (midpoint {flagship['ms']:.3f}); "
          f"steps/ray {render_entry['steps_per_ray']:.2f} (midpoint "
          f"{flagship['steps_per_ray']:.2f}); registers/spill {regs} "
          f"(midpoint {registers('render.cu', 'ILi0ELb0ELb1E')}); vs plain {d}")
    parent_gate("AB3 render", render_entry["ms"])

    # The staged AB3 render at 1080p: its march-kernel launches, and the
    # kernel alone on the recorded arguments.
    staged = dataclasses.replace(scene, march_cfg=dataclasses.replace(
        ab3, fused=False))
    march_u.launches = 0
    march_u.record = []
    frames = 3
    for _ in range(frames):
        img = render_radiance(staged, device=DEV)
    torch.cuda.synchronize()
    args, march_u.record = march_u.record[0], None
    RECORDED["ab3"] = args
    launches = march_u.launches
    if launches < frames or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"staged AB3 render: {launches} march launches")
    plain_args = (*args[:6], dataclasses.replace(args[6], approx_recip=False))
    # The midpoint march kernel on the same rays, for comparison.
    mid_args = (*args[:6], dataclasses.replace(args[6], multistep=False))
    with torch.no_grad():
        mid_ms, mid_out = kernel_time(lambda: march_u(*mid_args), 20)
    mid_steps = mid_out[2].float().mean()
    cmp, march_e = march_entry(
        "staged render() with multistep (AB3)", launches, args, plain_args,
        step_ops("ab3", args[6].approx_recip), variant="ab3",
        registers_spill=list(registers("march.cu", "ILi1ELb1E")),
        midpoint_ms=mid_ms, midpoint_steps_per_ray=float(mid_steps))
    print(f"1080p AB3 march kernel {march_e['ms']:.3f} ms, "
          f"{march_e['steps_per_ray']:.2f} steps/ray, registers/spill "
          f"{march_e['registers_spill']}; the midpoint march kernel on the "
          f"same rays {mid_ms:.3f} ms, {float(mid_steps):.2f} steps/ray, "
          f"{registers('march.cu', 'ILi0ELb1E')}; vs plain at exact divides "
          f"{cmp}")
    if not (cmp["frac_int_differ"] < 1e-3 and cmp["frac_gt_1e-4"] < 1e-3):
        raise AssertionError(f"1080p AB3 march kernel vs plain failed: {cmp}")
    parent_gate("staged AB3 march", march_e["ms"])
    return out, [render_entry, march_e]


CERTIFIED_CFG = dataclasses.replace(FLAGSHIP_CFG, refine_band=0.6,
                                    refine_budget=16384)


def phase_band_plane():
    cfg = dataclasses.replace(CERTIFIED_CFG, max_steps=48,
                              approx_recip=False)
    scene = flagship_scene(250, 141, cfg=cfg, features=Features())
    row, st = kernel_inputs(scene, None, DEV)
    k = render_planes_kernel(row, st)
    p = render_planes(row, st)
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.999)
    ref = critical_band_metric_u(m, a, camera_rays_u(scene.camera, m, a))
    torch.cuda.synchronize()
    out = {"planes": int(k.shape[0]),
           "band_vs_plain_max": float((k[3] - p[3]).abs().max()),
           "rgb_vs_plain_max": float((k[:3] - p[:3]).abs().max()),
           "band_vs_metric_max": float((k[3].reshape(-1) - ref).abs().max()),
           "share_below": float((k[3] < 0.6).float().mean())}
    print(f"band plane (250x141, a = 0.999, refine_band = 0.6): {out}")
    if not (out["planes"] == 4 and out["band_vs_plain_max"] < 1e-3
            and out["rgb_vs_plain_max"] < 1e-3
            and out["band_vs_metric_max"] < 1e-3
            and 0.0 < out["share_below"] < 0.05):
        raise AssertionError(f"band plane failed: {out}")
    return out


def phase_certified():
    """Phase 9: the certified render on the ported kernels."""
    band_plane = phase_band_plane()
    width, height = 1920, 1080
    n_pix = width * height
    scene = flagship_scene(width, height, cfg=CERTIFIED_CFG)
    (frame_ms, frame_min, frame_max), launches = render_frames(scene)
    if launches != {"render": 30, "march": 30, "tonemap": 30}:
        raise AssertionError(f"certified frames' launches: {launches}")

    # The kernel with its band plane, alone and against its plain version.
    render_e, _, planes, st = render_kernel_entry(
        scene, launches["render"], step_ops("midpoint", True),
        OPS_PER_PIXEL + OPS_PER_PIXEL_BAND, 16,
        "blackhole_simulation_tpu/ops/pallas_render.py:140",
        path="certified render() (band plane)", variant="midpoint",
        frame_ms=frame_ms)
    parent_gate("certified render", render_e["ms"])
    rgb, band = planes[:3].reshape(3, -1), planes[3].reshape(-1)
    band_px = int((band < CERTIFIED_CFG.refine_band).sum())

    # The refinement pass alone, and its re-march kernel alone.
    refine = lambda: refine_critical_band(scene, st.cfg, None, rgb, band)
    refine()
    pass_ms, pass_min, pass_max = timed(refine, 10)
    march_u.record = []
    refine()
    args, march_u.record = march_u.record[0], None
    RECORDED["refinement"] = args
    cmp, march_e = march_entry(
        "certified render(): the refinement re-march", launches["march"],
        args, args, step_ops("midpoint", args[6].approx_recip),
        variant="midpoint", refine_pass_ms=pass_ms,
        refine_pass_ms_min_max=[pass_min, pass_max])
    if not (cmp["frac_int_differ"] < 1e-3 and cmp["frac_gt_1e-4"] < 1e-3):
        raise AssertionError(f"refinement march kernel vs plain: {cmp}")
    info = {"frame_ms": frame_ms, "frame_ms_min_max": [frame_min, frame_max],
            "mrays_per_s": n_pix / frame_ms / 1e3, "launches": launches,
            "band_px": band_px, "budget": CERTIFIED_CFG.refine_budget,
            "overflow": band_px > CERTIFIED_CFG.refine_budget,
            "refine_pass_ms": pass_ms, "refine_march_ms": march_e["ms"],
            "refine_steps_sum": march_e["steps_sum"],
            "refine_steps_max": march_e["steps_max"],
            "band_plane": band_plane}
    print(f"certified render() 1920x1080: {frame_ms:.3f} ms/frame median of 30"
          f" (min {frame_min:.3f}, max {frame_max:.3f}), "
          f"{info['mrays_per_s']:.1f} Mrays/s; launches {launches}; band "
          f"{band_px} px (budget {CERTIFIED_CFG.refine_budget}); render kernel"
          f" {render_e['ms']:.3f} ms; refinement pass {pass_ms:.3f} ms; its "
          f"march kernel {march_e['ms']:.3f} ms, steps sum "
          f"{march_e['steps_sum']} "
          f"max {march_e['steps_max']}; march vs plain {cmp}")
    info["band_agreement"] = phase_band_agreement()
    info["staged_vs_fused"] = phase_refined_staged_vs_fused()
    return info, [render_e, march_e]


def phase_band_agreement(width=1920, height=1080, band_width=0.6,
                         budget=16384):
    """tools/band_agreement.py:64-79 on the port: the production march, the
    fine reference march and the refinement splice, on the card. The band
    is ``critical_band_metric_u`` of the camera rays, as in the tool; the
    spliced pixels are those the certified render refines: ``select_band``
    on the render kernel's band plane. The refinement march is the fine
    reference march by construction (``refinement_config`` of the
    production config is step 0.03, 4096 steps, ``max_step`` 1, exact
    divides, no precull), so the agreement measures how far the selection
    covers the band."""
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.999)
    prod = MarchConfig(max_steps=256, step_rate=0.2, use_pallas=True,
                       shadow_precull=True, far_step_cap_rate=0.4,
                       far_boost_radius=20.0, approx_recip=True,
                       midpoint_iters=1)
    fine = dataclasses.replace(prod, step_rate=0.03, max_steps=4096,
                               max_step=1.0, approx_recip=False,
                               shadow_precull=False)
    cam = _camera(width, height)
    rays = camera_rays_u(cam, m, a)
    bandm = critical_band_metric_u(m, a, rays)
    hit_prod = march_rows(rays, m, a, prod).hit
    hit_fine = march_rows(rays, m, a, fine).hit
    in_band = bandm < band_width
    # The certified render's own selection, from its kernel's band plane.
    cert = dataclasses.replace(prod, fused=True, refine_band=band_width,
                               refine_budget=budget)
    row, st = kernel_inputs(flagship_scene(width, height, cfg=cert), None,
                            DEV)
    plane = render_planes_kernel(row, st)[3].reshape(-1)
    n = plane.shape[0]
    sel = select_band(plane, height, width, min(budget, n), band_width)
    hit_ref = march_rows(camera_rays_u(cam, m, a,
                                       pix_ids=torch.clamp(sel, max=n - 1)),
                         m, a, refinement_config(prod)).hit
    # Out-of-band entries (id n) land in a padding slot that is cut off.
    hit_refined = torch.cat([hit_prod, hit_prod.new_zeros(1)])
    hit_refined[sel] = hit_ref
    hit_refined = hit_refined[:n]
    refined = torch.zeros(n + 1, dtype=torch.bool, device=DEV)
    refined[sel] = True
    refined = refined[:n]
    agree = lambda h, msk: float((h == hit_fine)[msk].float().mean())
    everywhere = torch.ones_like(in_band)
    out = {"size": f"{width}x{height}", "band_px": int(in_band.sum()),
           "band_frac": float(in_band.float().mean()), "budget": budget,
           "overflow": int(in_band.sum()) > budget,
           "plane_band_px": int((plane < band_width).sum()),
           "refined_px": int(refined.sum()),
           "band_px_left_coarse": int((in_band & ~refined).sum()),
           "agree_band_coarse": agree(hit_prod, in_band),
           "agree_band_refined": agree(hit_refined, in_band),
           "agree_all_coarse": agree(hit_prod, everywhere),
           "agree_all_refined": agree(hit_refined, everywhere)}
    print(f"band agreement (select_band on the kernel's band plane): {out}")
    if not out["agree_band_refined"] >= 0.99:
        raise AssertionError(f"band agreement below 0.99: {out}")
    return out


def phase_refined_staged_vs_fused():
    cfg = MarchConfig(max_steps=48, use_pallas=True, fused=True,
                      shadow_precull=True, far_step_cap_rate=0.4,
                      far_boost_radius=20.0, midpoint_iters=1,
                      step_rate=0.2, refine_band=0.5, refine_budget=256,
                      refine_step_rate=0.08, refine_max_steps=192)
    fused = flagship_scene(480, 270, spin=0.97, cfg=cfg, features=Features())
    staged = dataclasses.replace(fused, march_cfg=dataclasses.replace(
        cfg, use_pallas=False, fused=False))
    ia = render_radiance(fused, device=DEV)
    ib = render_radiance(staged, device=DEV)
    d = (ia - ib).abs()
    out = {"p99_abs": float(torch.quantile(d.flatten().double(), 0.99)),
           "mean_abs": float(d.mean()), "max_abs": float(d.max())}
    print(f"refined staged vs fused (480x270, a = 0.97): {out}")
    if not (bool(torch.isfinite(ia).all()) and out["p99_abs"] < 1e-3):
        raise AssertionError(f"refined staged vs fused failed: {out}")
    return out


# Phase 10: each new branch of the render kernel alone and all four
# together: (Features overrides, MarchConfig overrides, fov).
BRANCHES = {
    "jets": (dict(jets=True), {}, 0.5),
    "start_jitter": ({}, dict(start_jitter=0.5), 0.5),
    "nrs": (dict(nrs_far_field=True), {}, 1.0),
    "overlay": (dict(shadow_overlay=True), {}, 0.5),
    "all": (dict(jets=True, shadow_overlay=True, nrs_far_field=True),
            dict(start_jitter=0.5), 1.0),
}


def branch_scene(name, width, height, cfg, spin=0.9):
    feats, over, fov = BRANCHES[name]
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=fov,
                        width=width, height=height)
    scene = Scene.create(mass=1.0, spin=spin, camera=cam,
                         march_cfg=dataclasses.replace(cfg, **over),
                         features=Features(**feats))
    if feats.get("nrs_far_field"):
        scene = dataclasses.replace(scene, nrs_params=nrs_init(0, DEV))
    return scene


def phase_features_parity():
    """Phase 10 (a)-(c): each branch in the render kernel and the jets in
    the march kernel against their plain versions, and the staged against
    the fused render per feature."""
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48, approx_recip=False)
    out = {}
    for name in BRANCHES:
        row, st = kernel_inputs(branch_scene(name, 250, 141, cfg), None, DEV)
        s = diff_stats(render_planes_kernel(row, st), render_planes(row, st))
        s["bit_equal"] = s["max_abs"] == 0.0
        print(f"render kernel vs plain, {name} (250x141, 48 steps): {s}")
        if not (s["p99_abs"] < 1e-4 and s["mean_abs"] < 1e-5):
            raise AssertionError(f"render kernel {name} vs plain: {s}")
        out[f"render_{name}"] = s

    m, a = _cuda_scalar(1.0), _cuda_scalar(0.9)
    mcfg = dataclasses.replace(cfg, fused=False, shadow_precull=False)
    with torch.no_grad():
        args = _march_inputs(camera_rays_u(_camera(250, 141), m, a), m, a,
                             mcfg, None)
        k = march_u(*args, mcfg, JetParams())
        p = march_u_plain(*args, mcfg, JetParams())
    torch.cuda.synchronize()
    s = march_compare(k, p)
    s["jet_rel"] = float(((k[8] - p[8]).abs() / (p[8].abs() + 1e-12)).max())
    s["jet_max"] = float(p[8].max())
    print(f"jets march kernel vs plain (250x141, 48 steps): {s}")
    if not (s["frac_int_differ"] == 0.0 and s["max_abs"] < 1e-4
            and s["jet_rel"] < 1e-5 and s["jet_max"] > 1e-3):
        raise AssertionError(f"jets march kernel vs plain: {s}")
    out["march_jets"] = s

    scfg = dataclasses.replace(FLAGSHIP_CFG, approx_recip=False)
    for name in ("jets", "start_jitter", "nrs", "overlay"):
        fused = branch_scene(name, 480, 270, scfg, spin=0.999)
        staged = dataclasses.replace(fused, march_cfg=dataclasses.replace(
            fused.march_cfg, fused=False))
        fn = render if name == "overlay" else render_radiance
        march_u.launches = 0
        ia = fn(staged, device=DEV)
        torch.cuda.synchronize()
        launches = march_u.launches
        d = (ia - fn(fused, device=DEV)).abs()
        st = {"p99_abs": float(torch.quantile(d.flatten().double(), 0.99)),
              "mean_abs": float(d.mean()), "max_abs": float(d.max()),
              "march_launches": launches}
        print(f"staged vs fused, {name} (480x270, 256 steps): {st}")
        if not (launches >= 1 and bool(torch.isfinite(ia).all())
                and st["p99_abs"] < 1e-4 and st["mean_abs"] < STAGED_MEAN_BAR):
            raise AssertionError(f"staged vs fused {name}: {st}")
        out[f"staged_{name}"] = st
    return out


def full_featured_scene(width, height):
    """The full-featured 1080p scene: ``cli render --set enable_jets=1``
    with fov 1.2 (so that rays lie beyond b_min), ``start_jitter=0.5``,
    the shadow overlay and the NRS far field on the port's seeded weights."""
    scene = scene_from_params(SimulationParams(enable_jets=True, fov=1.2),
                              width, height)
    return dataclasses.replace(
        scene, nrs_params=nrs_init(0, DEV),
        features=dataclasses.replace(scene.features, shadow_overlay=True,
                                     nrs_far_field=True),
        march_cfg=dataclasses.replace(scene.march_cfg, start_jitter=0.5))


def far_pixels(scene):
    """The pixels beyond the NRS threshold (b is conserved, so the camera
    rays' count is the kernel's)."""
    from blackhole_simulation_tpu_torch.ops.render import nrs_b_min

    m, a = _cuda_scalar(scene.bh.mass), _cuda_scalar(scene.bh.spin)
    far, _ = nrs_far_field_rows(scene.nrs_params,
                                camera_rays_u(scene.camera, m, a), m, a,
                                b_min=nrs_b_min(scene))
    return int(far.sum())


def phase_full_featured(flagship):
    """Phase 10 (d)-(e)."""
    width, height = 1920, 1080
    n_pix = width * height
    entries, info = [], {}
    for name, scene, marker in (
            ("jets", scene_from_params(SimulationParams(enable_jets=True),
                                       width, height), "ILi2ELb0ELb1E"),
            ("full-featured", full_featured_scene(width, height),
             "ILi2ELb1ELb1E")):
        (frame_ms, frame_min, frame_max), launches = render_frames(scene)
        if launches["render"] != 30:
            raise AssertionError(f"{name} frames' launches: {launches}")
        per_pixel = OPS_PER_PIXEL
        n_far = 0
        if name == "full-featured":
            n_far = far_pixels(scene)
            per_pixel += (OPS_PER_PIXEL_JITTER + OPS_PER_PIXEL_OVERLAY
                          + OPS_PER_PIXEL_NRS)
        regs = registers("render.cu", marker)
        if not scene.march_cfg.approx_recip:
            raise AssertionError(f"the {name} scene left the approx_recip "
                                 "route")
        entry, d, _, _ = render_kernel_entry(
            scene, launches["render"], step_ops("jets", True),
            per_pixel, 12, "blackhole_simulation_tpu/ops/pallas_render.py:140",
            path=f"{name} render() at 1920x1080", variant="jets",
            frame_ms=frame_ms,
            frame_ms_min_max=[frame_min, frame_max],
            mrays_per_s=n_pix / frame_ms / 1e3, registers_spill=list(regs),
            far_pixels=n_far)
        if n_far:
            # the far pixels' NRS background, on top of the per-pixel count
            extra, _ = bound(OPS_PER_FAR_PIXEL * n_far, 0)
            entry["bound_ms"] += extra
        print(f"{name} render() 1920x1080: {frame_ms:.3f} ms/frame median of "
              f"30 (min {frame_min:.3f}, max {frame_max:.3f}), "
              f"{entry['mrays_per_s']:.1f} Mrays/s; kernel {entry['ms']:.3f} "
              f"ms, bound {entry['bound_ms']:.3f} ms; steps/ray "
              f"{entry['steps_per_ray']:.2f}, sum {entry['steps_sum']}; far "
              f"pixels {n_far}; registers/spill {regs}; vs plain {d}")
        parent_gate(f"{name} render", entry["ms"])
        info[name] = {k: entry[k] for k in (
            "frame_ms", "frame_ms_min_max", "ms", "bound_ms", "steps_per_ray",
            "steps_sum", "registers_spill", "far_pixels")}
        entries.append(entry)

    # The staged jets render: the march kernel's jets instantiation, timed
    # alone on the arguments it received.
    scene = scene_from_params(SimulationParams(enable_jets=True), width,
                              height)
    staged = dataclasses.replace(scene, march_cfg=dataclasses.replace(
        scene.march_cfg, fused=False))
    march_u.launches = 0
    march_u.record = []
    frames = 3
    for _ in range(frames):
        img = render(staged)
    torch.cuda.synchronize()
    args, march_u.record = march_u.record[0], None
    RECORDED["jets"] = args
    launches = march_u.launches
    if launches < frames or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"staged jets render: {launches} march launches")
    if args[7] is None or args[6].approx_recip:
        raise AssertionError("the staged jets march took no jets")
    cmp, march_e = march_entry(
        "staged jets render() at 1920x1080", launches, args, args,
        step_ops("jets", False), variant="jets",
        registers_spill=list(registers("march.cu", "ILi2ELb0E")))
    print(f"1080p jets march kernel {march_e['ms']:.3f} ms, "
          f"{march_e['steps_per_ray']:.2f} steps/ray, registers/spill "
          f"{march_e['registers_spill']}; vs plain {cmp}")
    if not (cmp["frac_int_differ"] < 1e-3 and cmp["frac_gt_1e-4"] < 1e-3):
        raise AssertionError(f"1080p jets march kernel vs plain: {cmp}")
    entries.append(march_e)

    # (e) the flagship instantiations and frame.
    kept = {src: registers(src, marker)
            for src, marker in FLAGSHIP_MARKERS.items()}
    lo, hi = FLAGSHIP_FRAME_SPREAD_MS
    klo, khi = FLAGSHIP_KERNEL_SPREAD_MS
    info["flagship"] = {"registers_spill": kept,
                        "frame_ms": flagship["frame_ms"],
                        "kernel_ms": flagship["ms"],
                        "pr3_frame_spread_ms": [lo, hi],
                        "pr3_kernel_spread_ms": [klo, khi]}
    print(f"flagship instantiations' registers/spill {kept} (pinned: "
          f"{FLAGSHIP_REGISTERS}); phase 4 frame {flagship['frame_ms']:.3f} "
          f"ms (PR 3's spread {lo}-{hi} ms), kernel {flagship['ms']:.3f} ms "
          f"(PR 3's {klo}-{khi} ms)")
    if kept != FLAGSHIP_REGISTERS:
        raise AssertionError(f"flagship registers changed: {kept}")
    if not (flagship["frame_ms"] < hi * FRAME_SLACK
            and flagship["ms"] < khi * 1.05):
        raise AssertionError(f"flagship frame {flagship['frame_ms']} ms / "
                             f"kernel {flagship['ms']} ms above PR 3's "
                             f"spread {lo}-{hi} / {klo}-{khi} ms")
    return info, entries


# Phase 13's planted pairs for the min/max check: signed zeros, NaN of both
# signs, infinities, denormals, ordinary values.
MINMAX_VALUES = (0.0, -0.0, 1.0, -1.0, math.nan, -math.nan, math.inf,
                 -math.inf, 1e-40, -1e-40, 1e-6, 0.25)


def phase_census(kernels):
    """Phase 13: the SASS census of every instantiation's march loop
    (``tools/sass_census.py`` on this run's libraries), the contracted
    counts against the census's FP32 arithmetic, and march_step.cuh's
    one-instruction jmax / jmin against the compare-compare-select form
    they replaced on planted pairs: equal bit for bit, or both NaN, except
    the ties of opposite-sign zeros (reported)."""
    census = sass_census.run()
    print(f"census: {json.dumps(census)}")
    fp32 = {k: v["counts"]["FFMA"] + v["counts"]["FMUL"]
            + v["counts"]["FADD"] for k, v in census.items()}
    print(f"census FP32 arithmetic (FFMA + FMUL + FADD) of each march loop: "
          f"{json.dumps(fp32)}; counted operations per step: midpoint "
          f"{OPS_PER_STEP} exact / {OPS_PER_STEP_FUSED} contracted, AB3 "
          f"{OPS_PER_STEP_AB3} / {OPS_PER_STEP_AB3_FUSED}, jets term "
          f"{OPS_PER_STEP_JETS} / {OPS_PER_STEP_JETS_FUSED}")
    vals = torch.tensor(MINMAX_VALUES, dtype=torch.float32, device=DEV)
    a = vals.repeat_interleave(len(MINMAX_VALUES))
    b = vals.repeat(len(MINMAX_VALUES))
    got = minmax_check(a, b)
    torch.cuda.synchronize()
    bits = got.view(torch.int32)
    nan = torch.isnan(got)
    zero_tie = (a == 0) & (b == 0) & (torch.signbit(a) != torch.signbit(b))
    st = {"pairs": int(a.numel())}
    for name, new, old in (("max", 0, 1), ("min", 2, 3)):
        same = (bits[new] == bits[old]) | (nan[new] & nan[old])
        st[f"{name}_differ"] = int((~same).sum())
        st[f"{name}_differ_not_zero_tie"] = int((~same & ~zero_tie).sum())
        st[f"{name}_nan_bits_differ"] = int(
            (nan[new] & nan[old] & (bits[new] != bits[old])).sum())
        st[f"{name}_zero_ties"] = [
            [float(x), float(y), float(got[new, i]), float(got[old, i])]
            for i, (x, y) in enumerate(zip(a.tolist(), b.tolist()))
            if bool(zero_tie[i]) and bits[new, i] != bits[old, i]]
    print(f"min/max, one FMNMX against compare-compare-select on planted "
          f"pairs: {json.dumps(st)}")
    if st["max_differ_not_zero_tie"] or st["min_differ_not_zero_tie"]:
        raise AssertionError(f"jmax/jmin differ from the old form: {st}")
    for e in kernels:
        if e["name"] in ("render", "march") and e.get("ms"):
            e["share_of_bound"] = e["bound_ms"] / e["ms"]
            if e["share_of_bound"] > 1.0:
                raise AssertionError(f"{e['name']} ({e.get('path')}) reads "
                                     f"above its bound: {e}")
    return {"census": census, "minmax": st}


# Phase 14: the oracle gates on the card. The gate scene of
# tests/test_oracle_gate.py: r = 30, theta = pi/2 - 0.25, fov 0.5, no star
# spots (their exp(-40 d^2) shading turns an escape direction's last digits
# into radiance), 256 steps; the fast paths at the validation step.
GATE_STARS = StarfieldParams(density=0.0)
FINE = dict(step_rate=0.03, max_steps=1024)
F64 = torch.float64


def gate_scene(spin, width, height, disk=True, cfg=MarchConfig(max_steps=256),
               turbulence=None):
    scene = Scene.create(mass=1.0, spin=spin, camera=_camera(width, height),
                         features=Features(disk=disk), stars=GATE_STARS,
                         march_cfg=cfg)
    if turbulence is not None:
        scene = dataclasses.replace(scene, disk=dataclasses.replace(
            scene.disk, turbulence=turbulence))
    return scene


def fine(scene, **over):
    return dataclasses.replace(scene, march_cfg=dataclasses.replace(
        scene.march_cfg, **{**FINE, **over}))


def _f64(v, device=None):
    return torch.tensor(float(v), dtype=F64, device=device or DEV)


def oracle_result(scene, device=None, pix=None):
    """(rays, MarchResult, seconds) of the float64 oracle on ``device``
    (``DEV`` by default): the whole frame, or the row-major pixel ids
    ``pix``."""
    device = device or DEV
    m, a = _f64(scene.bh.mass, device), _f64(scene.bh.spin, device)
    t0 = time.perf_counter()
    if pix is None:
        rays = camera_rays(scene.camera, m, a, dtype=F64)
    else:
        rays = camera_rays_indexed(scene.camera, m, a,
                                   torch.as_tensor(pix, device=device),
                                   dtype=F64)
    res = oracle_march(rays, m, a, scene.march_cfg)
    if device != "cpu":
        torch.cuda.synchronize()
    return rays, res, time.perf_counter() - t0


def oracle_image(scene, rays, res):
    m, a = _f64(scene.bh.mass, rays.device), _f64(scene.bh.spin, rays.device)
    return shade_sample(res, m, a, scene, rays)


def image_gate(img_fast, img_oracle):
    """bench.py's gate_full statistics (:366-372): the share of pixels
    within 1e-2 (1 + |oracle|), and the 97.5%-trimmed mean |d| over the
    oracle's mean radiance."""
    d = np.abs(img_fast - img_oracle).max(axis=2)
    scale = float(np.abs(img_oracle).mean()) + 1e-8
    frac_ok = float((d < 1e-2 * (1.0 + np.abs(img_oracle).max(axis=2))).mean())
    trimmed = np.sort(d.reshape(-1))[: int(d.size * 0.975)]
    return frac_ok, float(trimmed.mean() / scale)


def oracle_card_vs_cpu(width=24, height=16):
    """(a) The oracle on the card against the same oracle on the CPU (the
    CPU run is the reference, named as one): hit codes identical on >= 99%
    of rays, image p99 |d| < 1e-6."""
    scene = gate_scene(0.999, width, height)
    rays, res, secs = oracle_result(scene)
    img = oracle_image(scene, rays, res).cpu().numpy()
    cpu_rays, cpu_res, cpu_secs = oracle_result(scene, device="cpu")
    ref = oracle_image(scene, cpu_rays, cpu_res).numpy()
    d = np.abs(img - ref).max(axis=1)
    same = float((res.hit.cpu() == cpu_res.hit).float().mean())
    out = {"size": [width, height], "hit_same": same, "max_abs": float(d.max()),
           "p99_abs": float(np.percentile(d, 99)), "card_s": secs,
           "cpu_reference_s": cpu_secs,
           "steps_max": int(res.steps.max()), "dtype": str(img.dtype)}
    print(f"oracle card vs CPU reference {width}x{height} a=0.999: {out}")
    if not (same >= 0.99 and out["p99_abs"] < 1e-6 and img.dtype == np.float64
            and res.state.device.type == "cuda"):
        raise AssertionError(f"oracle on the card vs the CPU: {out}")
    return out


def eager_oracle_result(scene):
    """oracle_result with the trial blocks run eagerly (no CUDA graph)."""
    keep = oracle_module.graphed_blocks
    oracle_module.graphed_blocks = lambda trials, carry, *rest: (carry, 0)
    try:
        return oracle_result(scene)
    finally:
        oracle_module.graphed_blocks = keep


def gate_full(size=256):
    """(b) bench.py:336-389 on the card: the fast render at the validation
    step against the oracle at 256x256, a = 0.999, on the scene's own
    staged route (march kernel) and on the fused one (render kernel). The
    oracle runs twice, its trial blocks as CUDA graphs and eagerly: the two
    must be bit-equal; both are timed."""
    scene = gate_scene(0.999, size, size)
    rays, res, oracle_s = oracle_result(scene)
    _, eager, eager_s = eager_oracle_result(scene)
    same = all(torch.equal(getattr(res, f.name), getattr(eager, f.name))
               for f in dataclasses.fields(res))
    if not same:
        raise AssertionError("the graphed oracle differs from the eager one")
    ref = oracle_image(scene, rays, res).reshape(size, size, 3).cpu().numpy()
    out = {"size": size, "spin": 0.999, "oracle_s": oracle_s,
           "oracle_eager_s": eager_s, "graphed_equals_eager": same,
           "oracle_steps_max": int(res.steps.max())}
    for route, over in (("staged", {}),
                        ("fused", dict(use_pallas=True, fused=True))):
        march_u.launches = render_planes_kernel.launches = 0
        img = render_radiance(fine(scene, **over), device=DEV).cpu().numpy()
        frac_ok, trimmed_rel = image_gate(img, ref)
        out[route] = {"frac_ok": frac_ok, "trimmed_rel": trimmed_rel,
                      "launches": {"march": march_u.launches,
                                   "render": render_planes_kernel.launches}}
        kernel = "march" if route == "staged" else "render"
        if not (frac_ok > 0.98 and trimmed_rel < 1e-2
                and out[route]["launches"][kernel] == 1):
            raise AssertionError(f"gate_full {route}: {out}")
    print(f"gate_full: {out}")
    return out


def gate_1080p(width=1920, height=1080, n_sub=4096):
    """(c) bench.py:391-466 on the card: the certified flagship frame
    (approx_recip, refine_band 0.6, analytic shading) at 4096 stratified
    pixels against the oracle through camera_rays_indexed in float64."""
    scene = Scene.create(mass=1.0, spin=0.999, camera=_camera(width, height),
                         stars=GATE_STARS, march_cfg=CERTIFIED_CFG)
    t0 = time.perf_counter()
    img = render_radiance(scene, device=DEV).reshape(-1, 3).cpu().numpy()
    render_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    stride = (width * height) // n_sub
    pix = (np.arange(n_sub) * stride
           + rng.integers(0, stride, n_sub)).astype(np.int64)
    rays, res, oracle_s = oracle_result(scene, pix=pix)
    orc = oracle_image(scene, rays, res).cpu().numpy()
    d = np.abs(img[pix] - orc).max(axis=1)
    om = np.abs(orc).max(axis=1)
    bright = om > 0.02
    out = {
        "n_pixels": n_sub, "config": "flagship 1920x1080 a=0.999 refined "
        "band<0.6, analytic", "frac_ok": float((d < 1e-2 * (1.0 + om)).mean()),
        "abs_err_p99": float(np.percentile(d, 99)),
        "rel_err_bright_median": float(np.median(
            d[bright] / (om[bright] + 1e-3))) if bright.any() else 0.0,
        "n_bright": int(bright.sum()), "render_s": render_s,
        "oracle_s": oracle_s, "oracle_steps_max": int(res.steps.max()),
    }
    print(f"gate_1080p: {out}")
    if not (out["frac_ok"] > 0.98 and out["abs_err_p99"] < 1e-2
            and out["rel_err_bright_median"] < 0.05):
        raise AssertionError(f"gate_1080p: {out}")
    return out


def convergence_ladder(width=48, height=32):
    """(d) tests/test_oracle_gate.py:105-155 through the port's ``march``
    (the march kernel): median escape-direction angle against the oracle's
    at step rates 0.2, 0.1, 0.05, a = 0."""
    scene = gate_scene(0.0, width, height, disk=False)
    m32, a32 = _cuda_scalar(1.0), _cuda_scalar(0.0)
    rays32 = camera_rays(scene.camera, m32, a32)
    rays64, ro, oracle_s = oracle_result(scene)
    m64, a64 = _f64(1.0), _f64(0.0)
    d_o = escape_direction(ro.state, m64, a64)
    medians = []
    for step_rate, max_steps in ((0.2, 256), (0.1, 512), (0.05, 1024)):
        cfg = dataclasses.replace(scene.march_cfg, step_rate=step_rate,
                                  max_steps=max_steps)
        rf = march(rays32, m32, a32, cfg)
        both = (rf.hit == HIT_ESCAPE) & (ro.hit == HIT_ESCAPE)
        d_f = escape_direction(rf.state, m32, a32)[both]
        cos_a = torch.clamp((d_f * d_o[both].float()).sum(dim=1), -1.0, 1.0)
        medians.append(float(torch.median(torch.arccos(cos_a))))
    out = {"medians_rad": medians, "oracle_s": oracle_s}
    print(f"convergence ladder {width}x{height} a=0: {out}")
    if not (medians[0] < 2e-2 and medians[1] < 0.55 * medians[0]
            and medians[2] < 0.55 * medians[1] and medians[2] < 1.5e-3):
        raise AssertionError(f"convergence ladder: {out}")
    return out


def param_gate(name, oracle_images, ad_grad, p0, eps, width=48, height=32):
    """tests/test_oracle_gate.py:236-380's stable-pixel gate: the oracle's
    central difference at eps and eps / 2 defines the stable pixels (> 70%
    of them); the fast path's autograd of a seeded stable-pixel weighting
    must have the oracle FD's sign and be within rel 0.2 of it."""
    img = dict(zip((p0 + eps, p0 - eps, p0 + eps / 2, p0 - eps / 2),
                   oracle_images([p0 + eps, p0 - eps, p0 + eps / 2,
                                  p0 - eps / 2])))
    fd = (img[p0 + eps] - img[p0 - eps]) / (2 * eps)
    fd2 = (img[p0 + eps / 2] - img[p0 - eps / 2]) / eps
    denom = np.abs(fd) + np.abs(fd2) + 1e-2
    stable = (np.abs(fd - fd2) / denom < 0.05).all(axis=2)
    rng = np.random.default_rng(0)
    weights = (rng.uniform(0.5, 1.5, size=(height, width, 3))
               * stable[..., None]).astype(np.float32)
    g_ad = ad_grad(p0, torch.from_numpy(weights).to(DEV))
    g_fd = float(np.sum(fd * weights))
    rel = abs(g_ad - g_fd) / (abs(g_fd) + 1e-6)
    out = {"stable": float(stable.mean()), "ad": g_ad, "oracle_fd": g_fd,
           "rel": rel}
    print(f"d/d({name}) gate: {out}")
    if not (stable.mean() > 0.7 and np.sign(g_ad) == np.sign(g_fd)
            and rel < 0.2):
        raise AssertionError(f"d/d({name}) gate: {out}")
    return out


# The oracle frames of the gradient gates, by (parameter, value): phase 14
# renders them, phase 22 gates render_radiance's gradients on the same.
ORACLE_FRAMES = {}


def gate_oracle_images(field, base):
    """The oracle images of ``base`` with ``field`` ("spin" or "theta_cam")
    at each of a list of values, rendered once per value (ORACLE_FRAMES)."""
    def scene_at(v):
        if field == "spin":
            return dataclasses.replace(base, bh=dataclasses.replace(
                base.bh, spin=v))
        return dataclasses.replace(base, camera=dataclasses.replace(
            base.camera, theta=v))

    def images(values):
        for v in values:
            if (field, v) not in ORACLE_FRAMES:
                sc = scene_at(v)
                rays, res, _ = oracle_result(sc)
                ORACLE_FRAMES[(field, v)] = oracle_image(sc, rays, res).reshape(
                    sc.camera.height, sc.camera.width, 3).cpu().numpy()
        return [ORACLE_FRAMES[(field, v)] for v in values]

    return images


def gradient_gates(width=48, height=32):
    """(e) d/d(spin), d/d(density) and d/d(theta_cam) at a = 0.999,
    turbulence 0, the validation step, each against the card's oracle FD."""
    n = width * height
    base = gate_scene(0.999, width, height, turbulence=0.0)
    ids = torch.arange(n, device=DEV)

    def forward_grad(p0, weights, field):
        vals = {"spin": 0.999, "theta_cam": float(base.camera.theta),
                "density": base.disk.density, "t_peak": base.disk.t_peak}
        vals[field] = p0
        leaf = _cuda_scalar(p0, grad=True)
        params = InverseParams.init(device=DEV, **{
            k: v for k, v in vals.items() if k != field})
        params = dataclasses.replace(params, **{field: leaf})
        rgb = _forward(params, fine(base), ids).reshape(height, width, 3)
        return float(torch.autograd.grad(torch.sum(rgb * weights), leaf)[0])

    def density_frames(values):
        # The march does not depend on the density: one oracle march,
        # shaded at each density.
        rays, res, _ = oracle_result(base)
        return [oracle_image(dataclasses.replace(
            base, disk=dataclasses.replace(base.disk, density=v)), rays,
            res).reshape(height, width, 3).cpu().numpy() for v in values]

    def density_grad(p0, weights):
        dens = _cuda_scalar(p0, grad=True)
        rgb = render_sample_scaled(fine(base), density_scale=dens
                                   / base.disk.density, device=DEV)
        loss = torch.sum(rgb.reshape(height, width, 3) * weights)
        return float(torch.autograd.grad(loss, dens)[0])

    march_u.launches = march_grad_kernel.launches = 0
    t0 = time.perf_counter()
    out = {
        "spin": param_gate(
            "spin", gate_oracle_images("spin", base),
            lambda p, w: forward_grad(p, w, "spin"), 0.999, 5e-4, width,
            height),
        "density": param_gate("density", density_frames, density_grad, 0.7,
                              0.05, width, height),
        "theta_cam": param_gate(
            "theta_cam", gate_oracle_images("theta_cam", base),
            lambda p, w: forward_grad(p, w, "theta_cam"),
            float(base.camera.theta), 2e-3, width, height),
    }
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {"march": march_u.launches,
                       "march_grad": march_grad_kernel.launches}
    # Three forward marches; the gradient kernel for spin and theta_cam
    # (the density enters after the march, which its gradient skips).
    if out["launches"] != {"march": 3, "march_grad": 2}:
        raise AssertionError(f"gradient gates' kernel launches: {out}")
    return out


def phase_oracle_gates():
    """Phase 14: the oracle gates on the card."""
    t0 = time.perf_counter()
    out = {"card_vs_cpu": oracle_card_vs_cpu(), "gate_full": gate_full(),
           "gate_1080p": gate_1080p(), "ladder": convergence_ladder(),
           "gradients": gradient_gates()}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 14 (oracle gates): {out['seconds']:.1f} s")
    return out


def phase_fd(steps=5, width=1920, height=1080, inverse_size=64,
             inverse_steps=48):
    """Phase 15: the central-difference inverse path. One step at 1080p in
    phase 7's configuration, timed (each step nine march-kernel launches),
    then tests/test_parallel.py:155-176's recovery of a = 0.85."""
    t0 = time.perf_counter()
    scene = flagship_scene(width, height, cfg=TRAIN_CFG, features=Features())
    state = fd_state_init(InverseParams.init(
        spin=0.9, theta_cam=float(scene.camera.theta), device=DEV))
    target = torch.zeros((height, width, 3), device=DEV)
    step = make_fd_inverse_step(scene, device=DEV)
    step(state, target)                      # warm-up
    torch.cuda.synchronize()
    results = []
    march_u.launches = 0
    step_ms, step_min, step_max = timed(
        lambda: results.append(step(state, target)), steps)
    launches = march_u.launches
    (vec, (m1, v1, t1)), loss = results[-1]
    n_rays = 9 * width * height
    out = {"step_ms": step_ms, "step_ms_min_max": [step_min, step_max],
           "mrays_per_s": n_rays / step_ms / 1e3, "march_launches": launches,
           "launches_per_step": launches / steps, "loss": float(loss),
           "vec": vec.tolist()}
    print(f"FD step 1920x1080: {step_ms:.3f} ms/step median of {steps} "
          f"(min {step_min:.3f}, max {step_max:.3f}), "
          f"{out['mrays_per_s']:.1f} Mrays/s (9 forward passes), "
          f"{launches} march launches")
    finite = all(math.isfinite(x) for x in [float(loss), *vec.tolist(),
                                            *m1.tolist(), *v1.tolist()])
    if launches != 9 * steps or not finite:
        raise AssertionError(f"FD step: {out}")

    cam = _camera(inverse_size, inverse_size)
    scene_true = Scene.create(mass=1.0, spin=0.85, camera=cam,
                              march_cfg=MarchConfig(max_steps=160))
    target = render_radiance(scene_true, device=DEV)
    march_u.launches = 0
    t1 = time.perf_counter()
    params, losses = inverse_render(
        scene_true, target, n_steps=inverse_steps, lr=0.04, method="fd",
        init=InverseParams.init(spin=0.55, theta_cam=float(cam.theta)),
        device=DEV)
    spin = float(params.spin)
    out["inverse"] = {"seconds": time.perf_counter() - t1, "spin": spin,
                      "first_loss": losses[0], "final_loss": losses[-1],
                      "march_launches": march_u.launches}
    print(f"fd_inverse_render 64x64 a=0.85 from 0.55, 48 steps: "
          f"{out['inverse']}")
    if not (losses[-1] < 0.2 * losses[0] and abs(spin - 0.85) < 0.02
            and march_u.launches == 9 * inverse_steps):
        raise AssertionError(f"fd_inverse_render: {out['inverse']}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 15 (central differences): {out['seconds']:.1f} s")
    return out


def profiled(fn):
    """(result, profile) of one call of ``fn`` under torch.profiler
    (``tools/train_probe.py::profile_once``): its kernel launches, device
    busy ms and idle share."""
    out, prof = train_probe.profile_once(fn)
    prof.pop("top")
    return out, prof


NRS_CFG = MarchConfig(max_steps=512, escape_radius=300.0,
                      far_step_cap_rate=0.4)


def nrs_far_field_error(params, width=1920, height=1080):
    """tests/test_models.py:86-112 at 1920x1080: the median angle (degrees)
    between the surrogate's deflected direction and the marched escape
    direction over the far, escaped rays, beside the straight line's; the
    march through the march kernel."""
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.6)
    cam = Camera.create(r=60.0, theta=math.pi / 2 - 0.2, fov=1.0,
                        width=width, height=height)
    rays = camera_rays_u(cam, m, a)
    far, dirs = nrs_far_field_rows(params, rays, m, a, b_min=12.0)
    march_u.launches = 0
    rows = march_rows(rays, m, a, NRS_CFG)
    torch.cuda.synchronize()
    launches = march_u.launches
    mdir = escape_direction_u_rows(tuple(rows.state_u[i] for i in range(8)),
                                   m, a)
    sdir = escape_direction_u_rows(tuple(rays[i] for i in range(8)), m, a)
    mask = far & (rows.hit == HIT_ESCAPE)

    def ang(d):
        dot = d[0] * mdir[0] + d[1] * mdir[1] + d[2] * mdir[2]
        return torch.rad2deg(torch.arccos(torch.clamp(dot.double(), -1.0,
                                                      1.0)))[mask]

    out = {"rays": int(mask.sum()), "march_launches": launches,
           "median_deg_nrs": float(ang(dirs).median()),
           "median_deg_straight": float(ang(sdir).median())}
    if not (launches == 1 and out["rays"] > 0
            and out["median_deg_nrs"] < 2.0
            and out["median_deg_nrs"] < 0.25 * out["median_deg_straight"]):
        raise AssertionError(f"NRS far field at {width}x{height}: {out}")
    return out


def label_launches_per_trial(x):
    """torch.profiler over one block of 32 RKF45 trials (the integrator's
    exit-test block) of rays like the label batch's, born as
    ``generate_training_data`` births them from b and a read back from its
    float32 inputs ``x``: every trial makes the same launches, so the
    labels' launches are this block's / 32 x their trials (the profiler's
    own cost over all of them is ~30 s)."""
    from blackhole_simulation_tpu_torch.geodesic import (
        IntegrationOptions,
        null_ray,
    )
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        KS,
        KerrMetric,
    )

    f64 = dict(dtype=torch.float64, device=DEV)
    b = x[:, 0].to(**f64) * 40.0
    bh = KerrMetric.create(1.0, x[:, 2].to(**f64), chart=KS, device=DEV)
    zero = torch.zeros_like(b)
    y0 = null_ray(torch.stack([zero, zero + 200.0, zero + math.pi / 2, zero],
                              dim=-1),
                  torch.stack([zero - 1.0, zero, b], dim=-1), bh)
    opts = IntegrationOptions(max_steps=16, escape_radius=300.0)
    _, prof = profiled(lambda: integrate(y0, bh, opts))
    if integrate.trials != 32:
        raise AssertionError(f"one block is 32 trials: {integrate.trials}")
    return prof


def phase_nrs(full_featured_ms):
    """Phase 16: NRS training at full size (tests/test_models.py:73-74):
    the labels on the card against the CPU's, 2,500 training steps on the
    card, 400 steps on the card against the CPU from the same weights, the
    trained surrogate's far field at 1080p, and the render kernel on the
    trained weights."""
    t0 = time.perf_counter()
    out = {}
    t1 = time.perf_counter()
    x, y = generate_training_data(n=384, seed=1, device=DEV)
    torch.cuda.synchronize()
    label_s = time.perf_counter() - t1
    trials = integrate.trials
    # The same labels with the trial blocks eager (no CUDA graph), and the
    # launches of one eager block.
    keep = integrate_module.graphed_blocks
    integrate_module.graphed_blocks = lambda trials, carry, *rest: (carry, 0)
    try:
        per_trial = label_launches_per_trial(x)
        t1 = time.perf_counter()
        x2, y2 = generate_training_data(n=384, seed=1, device=DEV)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t1
    finally:
        integrate_module.graphed_blocks = keep
    t1 = time.perf_counter()
    xc, yc = generate_training_data(n=384, seed=1, device="cpu")
    cpu_s = time.perf_counter() - t1
    d = (y.cpu() - yc).abs()
    out["labels"] = {
        "seconds": label_s, "eager_seconds": eager_s, "trials": trials,
        "eager_launches_per_trial": per_trial["launches"] / 32,
        "eager_launches_est": per_trial["launches"] / 32 * trials,
        "eager_idle_share_32_trials": per_trial["idle_share"],
        "graph_replays": -(-trials // 32),
        "cpu_reference_seconds": cpu_s, "escaped": int(yc[:, 2].sum()),
        "max_abs_deflection": float(d[:, 0].max()),
        "max_abs_delay": float(d[:, 1].max()),
        "graphed_equals_eager": bool(torch.equal(y2, y)
                                     and torch.equal(x2, x))}
    print(f"NRS labels n=384 on the card: {json.dumps(out['labels'])}")
    if not (out["labels"]["graphed_equals_eager"]
            and torch.equal(x.cpu(), xc) and torch.equal(y[:, 2].cpu(), yc[:, 2])
            and out["labels"]["max_abs_deflection"] < 1e-5
            and out["labels"]["max_abs_delay"] < 1e-5):
        raise AssertionError(f"NRS labels card vs CPU: {out['labels']}")

    steps = 2500
    t1 = time.perf_counter()
    params, losses = train_nrs(x, y, n_steps=steps, lr=5e-3, device=DEV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    _, step_prof = profiled(
        lambda: train_nrs(x, y, n_steps=1, lr=5e-3, device=DEV))
    start = nrs_init(0, "cpu")
    _, l_card = train_nrs(x, y, n_steps=400, lr=5e-3, params=start,
                          device=DEV)
    _, l_cpu = train_nrs(x.cpu(), y.cpu(), n_steps=400, lr=5e-3,
                         params=start, device="cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    out["training"] = {"steps": steps, "seconds": train_s,
                       "ms_per_step": train_s / steps * 1e3,
                       "first_loss": losses[0], "final_loss": losses[-1],
                       "launches_one_step_call": step_prof["launches"],
                       "card_vs_cpu_400_steps_rel": rel}
    print(f"NRS training on the card: {json.dumps(out['training'])}")
    if not (losses[-1] < 0.01 and rel < 1e-3):
        raise AssertionError(f"NRS training: {out['training']}")

    out["far_field"] = nrs_far_field_error(params)
    print(f"NRS far field 1920x1080, trained weights: "
          f"{json.dumps(out['far_field'])}")

    # The render kernel's NRS branch on the trained weights.
    cfg = dataclasses.replace(FLAGSHIP_CFG, max_steps=48, approx_recip=False)
    scene = dataclasses.replace(branch_scene("nrs", 250, 141, cfg),
                                nrs_params=params)
    row, st = kernel_inputs(scene, None, DEV)
    before = render_planes_kernel.launches
    s = diff_stats(render_planes_kernel(row, st), render_planes(row, st))
    s["far_pixels"] = far_pixels(scene)
    print(f"render kernel vs plain, trained NRS (250x141, 48 steps): {s}")
    if not (render_planes_kernel.launches == before + 1 and s["far_pixels"]
            and s["p99_abs"] < 1e-4 and s["mean_abs"] < 1e-5):
        raise AssertionError(f"render kernel, trained NRS: {s}")
    out["render_250x141"] = s

    width, height = 1920, 1080
    scene = dataclasses.replace(
        branch_scene("nrs", width, height, FLAGSHIP_CFG), nrs_params=params)
    (frame_ms, frame_min, frame_max), launches = render_frames(scene)
    n_far = far_pixels(scene)
    entry, d, _, _ = render_kernel_entry(
        scene, launches["render"], step_ops("midpoint", True),
        OPS_PER_PIXEL + OPS_PER_PIXEL_NRS, 12,
        "blackhole_simulation_tpu/ops/pallas_render.py:140",
        path="trained-NRS render() at 1920x1080", variant="midpoint",
        frame_ms=frame_ms, frame_ms_min_max=[frame_min, frame_max],
        far_pixels=n_far)
    extra, _ = bound(OPS_PER_FAR_PIXEL * n_far, 0)
    entry["bound_ms"] += extra
    entry["full_featured_kernel_ms"] = full_featured_ms
    print(f"trained-NRS render() 1920x1080: {frame_ms:.3f} ms/frame median "
          f"of 30 (min {frame_min:.3f}, max {frame_max:.3f}); kernel "
          f"{entry['ms']:.3f} ms beside the full-featured kernel's "
          f"{full_featured_ms:.3f} ms (phase 10), bound "
          f"{entry['bound_ms']:.3f} ms; far pixels {n_far}; steps/ray "
          f"{entry['steps_per_ray']:.2f}; vs plain {d}")
    if launches["render"] != 30 or not n_far:
        raise AssertionError(f"trained-NRS frames: {launches}, {n_far}")
    out["render_1080p"] = {k: entry[k] for k in (
        "frame_ms", "ms", "bound_ms", "far_pixels", "steps_per_ray")}
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 16 (NRS training): {out['seconds']:.1f} s")
    return out, [entry]


def phase_tiles(width=1920, height=1080, tile=64, batch_tiles=8):
    """Phase 17: the progressive tile renderer at 1080p on the flagship
    scene, staged: every pixel covered, one march launch per batch, the
    image against the staged ``render_radiance``."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(FLAGSHIP_CFG, fused=False)
    scene = flagship_scene(width, height, cfg=cfg)
    prog = ProgressiveRenderer(scene, tile, batch_tiles, device=DEV)
    batches = -(-prog.grid.n_tiles // batch_tiles)
    march_u.launches = 0
    march_u.record = []
    frame_ms, _, _ = timed(prog.render_all, 1)
    launches = march_u.launches
    args, march_u.record = march_u.record[0], None
    img = prog.image
    ref = render_radiance(scene, device=DEV)
    ref_ms, ref_min, ref_max = timed(
        lambda: render_radiance(scene, device=DEV), 5)
    frame2_ms, _, _ = timed(ProgressiveRenderer(scene, tile, batch_tiles,
                                                device=DEV).render_all, 1)
    # One batch under the profiler: every batch makes the same launches.
    _, prof = profiled(ProgressiveRenderer(scene, tile, batch_tiles,
                                           device=DEV).step)
    diff = (img - ref).abs().amax(dim=-1)
    out = {"tiles": prog.grid.n_tiles, "batches": batches,
           "march_launches": launches,
           "covered": bool(prog.covered.all()),
           "frac_below_1e-3": float((diff < 1e-3).float().mean()),
           "frac_bit_equal": float((img == ref).all(dim=-1).float().mean()),
           "max_abs": float(diff.max()), "finite": bool(
               torch.isfinite(img).all()),
           "frame_ms_runs": [frame_ms, frame2_ms],
           "render_radiance_ms": ref_ms,
           "render_radiance_ms_min_max": [ref_min, ref_max],
           "batch_wall_ms": prof["wall_ms"],
           "batch_device_busy_ms": prof["device_busy_ms"],
           "batch_idle_share": prof["idle_share"],
           "launches_per_batch": prof["launches"],
           "launches_per_frame": prof["launches"] * batches}
    print(f"progressive renderer {width}x{height}, tile {tile}, batch "
          f"{batch_tiles}: {json.dumps(out)}")
    if not (out["covered"] and out["finite"] and launches == batches
            and out["frac_below_1e-3"] > 0.998):
        raise AssertionError(f"progressive renderer: {out}")
    plain = dataclasses.replace(args[6], approx_recip=False)
    cmp, entry = march_entry(
        f"progressive tiles {width}x{height} (one batch of {batch_tiles} "
        "tiles)",
        launches, args, (*args[:6], plain, args[7]),
        step_ops("midpoint", True), variant="midpoint",
        batches_per_frame=batches)
    print(f"tile batch march kernel {entry['ms']:.3f} ms on {entry['rays']} "
          f"rays, bound {entry['bound_ms']:.3f} ms; exact route vs plain "
          f"{cmp}")
    if not (cmp["frac_int_differ"] < 1e-3 and cmp["frac_gt_1e-4"] < 1e-3):
        raise AssertionError(f"tile batch march kernel vs plain: {cmp}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 17 (progressive tiles): {out['seconds']:.1f} s")
    return out, [entry]


def _taa_frames(scene, keys, orbit):
    """The flagship's (H, W, 3) radiance frames: one per Halton jitter of
    ``keys``, or with ``orbit`` one per camera phi of ``keys``."""
    frames = []
    for c in keys:
        if orbit:
            cam = dataclasses.replace(scene.camera, phi=c)
            s = dataclasses.replace(scene, camera=cam)
            frames.append(render_radiance(s, device=DEV))
        else:
            frames.append(render_sample(scene, c, DEV).permute(1, 2, 0)
                          .contiguous())
    return frames


def _accumulate(frames, cams, device):
    """Every resolve of a TemporalAccumulator over ``frames`` on
    ``device`` (copied to the host), and on the card each resolve's
    CUDA-event ms and its launches (one more resolve under the profiler,
    whose state change is undone)."""
    acc = TemporalAccumulator()
    outs, ms, launches = [], [], []
    for f, cam in zip(frames, cams):
        f = f.to(device)
        resolve = lambda: acc.resolve(f, cam is not None, cam)
        if device != "cpu" and acc.history is not None:
            state = (acc.history, acc.frame_count, acc.prev_camera)
            launches.append(profiled(resolve)[1]["launches"])
            acc.history, acc.frame_count, acc.prev_camera = state
            ms.append(timed(resolve, 1)[0])
        else:
            resolve()
        outs.append(acc.history.cpu())
    return outs, ms, launches


def phase_taa(width=1920, height=1080, n_static=16, n_orbit=8):
    """Phase 18: TAA at 1080p, the card's accumulator against the CPU's on
    the same frames: a static Halton-jittered sequence (``taa_resolve``)
    and an orbit (``taa_resolve_reprojected``)."""
    t0 = time.perf_counter()
    scene = ensure_spectral_coeffs(flagship_scene(width, height))
    out = {}
    cam = scene.camera
    for name, keys, cams in (
            ("static", list(halton_jitters(n_static)), [None] * n_static),
            ("orbit", [cam.phi + 0.01 * k for k in range(n_orbit)],
             [(cam.r, cam.theta, cam.phi + 0.01 * k, cam.fov, cam.roll)
              for k in range(n_orbit)])):
        frames = _taa_frames(scene, keys, name == "orbit")
        card, ms, launches = _accumulate(frames, cams, DEV)
        host, _, _ = _accumulate([f.cpu() for f in frames], cams, "cpu")
        d = max(float((a - b).abs().max()) for a, b in zip(card, host))
        out[name] = {"frames": len(frames), "max_abs": d,
                     "bit_equal": all(torch.equal(a, b)
                                      for a, b in zip(card, host)),
                     "resolve_ms_median": float(np.median(ms)),
                     "resolve_ms_min_max": [min(ms), max(ms)],
                     "launches_per_resolve": float(np.median(launches)),
                     "finite": all(bool(torch.isfinite(a).all())
                                   for a in card)}
        print(f"TAA {name} {width}x{height} ({len(frames)} frames), card vs "
              f"CPU: {json.dumps(out[name])}")
        if not (d < 1e-5 and out[name]["finite"]):
            raise AssertionError(f"TAA {name}: {out[name]}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18 (TAA): {out['seconds']:.1f} s")
    return out


def _engine_values(eng):
    """The engine's scalar API (float64 numbers)."""
    return {
        "horizon": eng.compute_horizon(),
        "isco": [eng.compute_isco(), eng.compute_isco(False)],
        "photon_sphere": [eng.compute_photon_sphere(),
                          eng.compute_photon_sphere(False)],
        "dilation": eng.compute_dilation(eng.compute_isco()),
        "hawking": eng.compute_hawking_temperature(1.0),
        "disk_flux_mdot_2.5": eng.compute_disk_flux(8.0, 2.5),
        "g_factor": eng.compute_g_factor(8.0, 2.0),
        "shadow_radius": eng.compute_shadow_radius(),
        "shadow_shift": eng.compute_shadow_shift(),
    }


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.isfinite(b)
    if not np.array_equal(ok, np.isfinite(a)):
        return math.inf
    return float(np.max(np.abs(a[ok] - b[ok])
                        / np.maximum(np.abs(b[ok]), 1e-300), initial=0.0))


def phase_engine():
    """Phase 19: ``PhysicsEngine`` on the card against
    ``PhysicsEngine(device="cpu")`` in float64: the scalar API, the LUTs and
    meshes, the fields at ``cli fields``' defaults and on a 1024x1024
    grid, one tick of the native bridge, one ray."""
    t0 = time.perf_counter()
    native_dir = ROOT / "native"
    before = sorted((p.name, p.stat().st_mtime_ns) for p in
                    native_dir.iterdir())
    params = SimulationParams()
    card = PhysicsEngine(params.mass, params.spin, prefer_native=True,
                         device=DEV)
    host = PhysicsEngine(params.mass, params.spin, prefer_native=False,
                         device="cpu")
    out = {"bridge": type(card.bridge).__name__,
           "bridge_library": str(getattr(card.bridge, "path", None))}
    if not isinstance(card.bridge, NativeBridge):
        raise AssertionError(f"the native bridge did not load: {out}")
    r = np.linspace(1.2, 20.0, 64)
    th = np.linspace(0.05, np.pi - 0.05, 33)
    a, b = _engine_values(card), _engine_values(host)
    out["scalar_rel"] = {k: _rel_max(a[k], b[k]) for k in a}
    tables = {
        "disk_lut": lambda e: e.generate_disk_lut(512)[0],
        "spectrum_lut": lambda e: e.generate_spectrum_lut(256, 64),
        "embedding_mesh": lambda e: e.generate_embedding_mesh(),
        "ergosphere_mesh": lambda e: e.generate_ergosphere_mesh(),
    }
    out["tables_rel"] = {k: _rel_max(f(card), f(host))
                         for k, f in tables.items()}
    fields = {
        "kretschmann": lambda e, r, th: e.compute_kretschmann_field(r, th),
        "frame_drag": lambda e, r, th: e.compute_frame_drag_field(r, th),
        "light_cone_ks": lambda e, r, th: e.compute_light_cone_field(r, th),
        "light_cone_bl": lambda e, r, th: e.compute_light_cone_field(
            r, th, use_ks=False),
    }
    out["fields_rel"] = {k: _rel_max(f(card, r, th)[2], f(host, r, th)[2])
                         for k, f in fields.items()}
    r1 = np.linspace(1.2, 20.0, 1024)
    th1 = np.linspace(0.05, np.pi - 0.05, 1024)
    out["fields_1024_rel"], out["fields_1024_ms"] = {}, {}
    for k, f in fields.items():
        f(card, r1, th1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = f(card, r1, th1)[2]
        out["fields_1024_ms"][k] = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        ref = f(host, r1, th1)[2]
        out["fields_1024_ms"][f"{k}_cpu"] = (time.perf_counter() - t1) * 1e3
        out["fields_1024_rel"][k] = _rel_max(got, ref)
    snap = card.tick(0.02)
    out["tick"] = {"camera": snap["camera"], "physics": snap["physics"],
                   "shadow_points": int(snap["shadow_curve"].shape[0])}
    ray = [0.0, 20.0, math.pi / 2, 0.0, -1.0, -0.5, 0.0, 0.0]
    rc = card.integrate_ray_relativistic(ray, max_steps=20_000)
    rh = host.integrate_ray_relativistic(ray, max_steps=20_000)
    out["ray"] = {"termination": [rc["termination"], rh["termination"]],
                  "steps": [rc["steps_taken"], rh["steps_taken"]],
                  "final_rel": _rel_max(rc["final_state"],
                                        rh["final_state"])}
    card.close()
    host.close()
    out["native_untouched"] = before == sorted(
        (p.name, p.stat().st_mtime_ns) for p in native_dir.iterdir())
    print(f"PhysicsEngine card vs CPU: {json.dumps(out)}")
    worst = lambda d: max(d.values())
    if not (worst(out["scalar_rel"]) < 1e-12
            and worst(out["tables_rel"]) < 1e-10
            and worst(out["fields_rel"]) < 1e-10
            and worst(out["fields_1024_rel"]) < 1e-10
            and len(set(out["ray"]["termination"])) == 1
            and len(set(out["ray"]["steps"])) == 1
            and out["native_untouched"]
            and math.isfinite(snap["physics"]["horizon"])):
        raise AssertionError(f"PhysicsEngine card vs CPU: {out}")
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 19 (engine): {out['seconds']:.1f} s")
    return out


# Phase 20's sizes: the CLI still, the CLI's 480x270 default for the
# animation, benchmark and validation, the live session, and the inverse
# demo at its defaults.
APP = {"still": (1920, 1080), "small": (480, 270), "live": (1280, 720),
       "live_frames": 240, "live_profiled_frames": 48,
       "inverse": (96, 96), "inverse_steps": 60}


def _size_args(key):
    w, h = APP[key]
    return ("--width", str(w), "--height", str(h))


def _reset_launches():
    render_planes_kernel.launches = 0
    march_u.launches = 0
    march_grad_kernel.launches = 0


def _launches():
    return {"render": render_planes_kernel.launches,
            "march": march_u.launches,
            "march_grad": march_grad_kernel.launches}


def run_cli(*argv):
    """``app.cli.main(argv)`` with the launch counters reset just before it:
    (its stdout, wall seconds to its return, the kernel launches)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    return buf.getvalue(), secs, _launches()


def _direct_png(params, width, height, camera=None, certified=False):
    """encode_png of the clamped ``render()`` of the CLI's scene, computed
    directly on the card."""
    scene = scene_from_params(params, width, height, device=DEV)
    if camera is not None:
        scene = dataclasses.replace(scene, camera=camera)
    if certified:
        scene = dataclasses.replace(scene, march_cfg=dataclasses.replace(
            scene.march_cfg, refine_band=0.6, refine_budget=16384))
    return encode_png(render(scene, device=DEV).clamp(0.0, 1.0).cpu()
                      .numpy())


def _app_render(tmp):
    out = {}
    params = SimulationParams()
    w, h = APP["still"]
    for name, extra in (("render", ()), ("certified", ("--certified",))):
        path = os.path.join(tmp, f"{name}.png")
        runs = [run_cli("render", *_size_args("still"), *extra, "--out",
                        path) for _ in range(2)]
        with open(path, "rb") as f:
            data = f.read()
        img = load_png_rgb(path)
        equal = data == _direct_png(params, w, h, certified=bool(extra))
        out[name] = {"seconds": [r[1] for r in runs],
                     "launches": runs[-1][2], "png_shape": list(img.shape),
                     "png_equal_direct": equal}
    print(f"cli render {w}x{h}: {json.dumps(out)}")
    if not (out["render"]["png_equal_direct"]
            and out["render"]["png_shape"] == [h, w, 3]
            and out["render"]["launches"]["render"] == 1
            and out["certified"]["launches"]["render"] == 1
            and out["certified"]["launches"]["march"] == 1):
        raise AssertionError(f"cli render: {out}")
    return out


def _app_animate(tmp, frames=8):
    outdir = os.path.join(tmp, "frames")
    _, secs, launches = run_cli("animate", "--director", "grand_survey",
                                "--frames", str(frames), *_size_args("small"),
                                "--outdir", outdir)
    params = SimulationParams()
    w, h = APP["small"]
    scene0 = scene_from_params(params, w, h, device=DEV)
    equal = []
    for i in range(frames):
        r, theta, phi = grand_survey(i / 30.0)
        cam = Camera.create(r=r, theta=theta, phi=phi, fov=params.fov,
                            width=scene0.camera.width,
                            height=scene0.camera.height)
        with open(os.path.join(outdir, f"frame_{i:05d}.png"), "rb") as f:
            equal.append(f.read() == _direct_png(params, w, h, cam))
    out = {"seconds": secs, "launches": launches, "frames_equal": equal}
    print(f"cli animate grand_survey {frames} frames {w}x{h}: "
          f"{json.dumps(out)}")
    if not (all(equal) and launches["render"] == frames):
        raise AssertionError(f"cli animate: {out}")
    return out


def _live_stats(stats):
    """cli live's summary of run_live's stats."""
    fps = np.asarray(stats["fps"][2:] or [0.0])
    scales = stats["scales"]
    return {"frames": stats["frames"], "fps_mean": float(fps.mean()),
            "fps_p5": float(np.percentile(fps, 5)),
            "quality": stats["quality"],
            "calibrated_fps": stats["calibrated_fps"],
            "final_scale": scales[-1] if scales else None,
            "scale_changes": sum(1 for a, b in zip(scales, scales[1:])
                                 if a != b),
            "frame_ms_p95": stats["monitor"]["frame_ms_p95"]}


def _display_card_vs_cpu(cfg, width, height, term_cols=120):
    """The display program on the card and on the CPU, fed the same two
    card-rendered frames at the full rung (the second accumulated on the
    first): max |d| of the resolved frames and of the uint8 displays."""
    w, h = live.rung_size(width, height, 1.0)
    rows = max(2, (term_cols * height // width) // 2) * 2
    cams = [live.live_camera(30.0, 1.3, 0.2, 0.9),
            live.live_camera(29.8, 1.31, 0.25, 0.9)]
    frames = [live.render_live_frame(c, 1.0, cfg, w, h, DEV) for c in cams]
    res = {}
    for dev in (DEV, "cpu"):
        hist = prev = None
        for img, c in zip(frames, cams):
            cam_now = (*c[:3], 0.5, 0.0)
            disp, hist_new = live.display_program(
                img.to(dev), hist, prev, cam_now, hist is not None, rows,
                term_cols)
            hist, prev = hist_new, cam_now
        res[dev] = (disp.cpu(), hist.cpu())
    return {"rung": [w, h], "display": [rows, term_cols],
            "max_abs": float((res[DEV][1] - res["cpu"][1]).abs().max()),
            "max_uint8": int((res[DEV][0].int() - res["cpu"][0].int())
                             .abs().max()),
            "finite": bool(torch.isfinite(res[DEV][1]).all())}


def _app_live():
    if sys.stdout.isatty():
        raise AssertionError("phase 20 runs the live loop headless: stdout "
                             "must not be a terminal")
    frames, profiled_frames = APP["live_frames"], APP["live_profiled_frames"]
    width, height = APP["live"]
    kw = dict(width=width, height=height, script="orbit", device=DEV)
    _reset_launches()
    t0 = time.perf_counter()
    stats = live.run_live(frames=frames, calibrate=True, **kw)
    out = {"seconds": time.perf_counter() - t0, **_live_stats(stats),
           "launches": _launches()}
    _reset_launches()
    stats_p, prof = profiled(lambda: live.run_live(
        frames=profiled_frames, calibrate=False, **kw))
    out["profiled"] = {"frames": stats_p["frames"],
                       "render_launches": render_planes_kernel.launches,
                       "render_launches_per_frame":
                           render_planes_kernel.launches / stats_p["frames"],
                       "wall_ms": prof["wall_ms"],
                       "device_busy_ms": prof["device_busy_ms"],
                       "idle_share": prof["idle_share"],
                       "launches_per_frame":
                           prof["launches"] / stats_p["frames"]}
    cfg = live.live_march_config(out["quality"], True)
    out["display_card_vs_cpu"] = _display_card_vs_cpu(cfg, width, height)
    print(f"live {width}x{height} orbit: {json.dumps(out)}")
    disp = out["display_card_vs_cpu"]
    if not (out["frames"] > 0 and math.isfinite(out["fps_mean"])
            and out["profiled"]["render_launches_per_frame"] == 1.0
            and disp["max_abs"] <= 1e-5 and disp["finite"]):
        raise AssertionError(f"live: {out}")
    w, h = disp["rung"]
    cam = Camera.create(r=30.0, theta=1.3, phi=0.2, fov=0.5, width=w,
                        height=h)
    scene = Scene.create(mass=1.0, spin=0.9, camera=cam, march_cfg=cfg)
    entry, s, _, _ = render_kernel_entry(
        scene, out["launches"]["render"], step_ops("midpoint", True),
        OPS_PER_PIXEL, 12, "blackhole_simulation_tpu/ops/pallas_render.py:140",
        path=f"live loop full rung {w}x{h} (quality {out['quality']})",
        variant="midpoint")
    print(f"live rung render kernel {entry['ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms; vs plain {s}")
    return out, entry


def _final_fd_state(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}.npz")) as d:
        return [d[k].tobytes() for k in sorted(d.files)]


class _StopAfter(Exception):
    pass


def _app_inverse(tmp):
    steps = APP["inverse_steps"]
    size = _size_args("inverse")
    text, secs, launches = run_cli("inverse", *size, "--steps", str(steps))
    res = json.loads(text.strip().splitlines()[-1])
    out = {"seconds": secs, "seconds_per_step": secs / steps,
           "march_per_step": launches["march"] / steps,
           "grad_per_step": launches["march_grad"] / steps, **res}
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"cli inverse: {out}")
    a, b, c = (os.path.join(tmp, d) for d in ("ck_a", "ck_b", "ck_c"))
    argv = ("inverse", *size, "--steps", "10", "--checkpoint-dir")
    _, secs_a, launches_a = run_cli(*argv, a)
    save = CheckpointManager.save

    def save_then_stop(self, step, tree):
        path = save(self, step, tree)
        if step == 6:
            raise _StopAfter
        return path

    CheckpointManager.save = save_then_stop
    try:
        run_cli(*argv, b)
    except _StopAfter:
        pass
    finally:
        CheckpointManager.save = save
    stopped_at = CheckpointManager(b).steps()
    resumed, _, _ = run_cli(*argv, b)
    # The same stop through the arguments: a --steps 6 run, then --steps
    # 10. Its cosine schedule spans 6 steps, so it is expected to differ.
    run_cli("inverse", *size, "--steps", "6", "--checkpoint-dir", c)
    run_cli(*argv, c)
    out["checkpoint"] = {
        "fd_seconds_per_step": secs_a / 10,
        "fd_march_per_step": launches_a["march"] / 10,
        "steps_kept_at_stop": stopped_at,
        "resumed_from_6": "resumed from step 6" in resumed,
        "resumed_equal_uninterrupted":
            _final_fd_state(a, 10) == _final_fd_state(b, 10),
        "steps_6_then_10_equal":
            _final_fd_state(a, 10) == _final_fd_state(c, 10)}
    print(f"cli inverse {size[1]}x{size[3]}: {json.dumps(out)}")
    ck = out["checkpoint"]
    if not (ck["resumed_from_6"] and ck["resumed_equal_uninterrupted"]
            and stopped_at == [2, 4, 6] and launches["march_grad"] > 0):
        raise AssertionError(f"cli inverse: {out}")
    return out


def _app_bench_validate():
    text, secs, _ = run_cli("bench", *_size_args("small"), "--seconds", "1")
    lines = text.strip().splitlines()
    presets = [json.loads(line) for line in lines[:-1]]
    bench = {"seconds": secs, "presets": presets,
             "recommended": lines[-1].split(": ", 1)[1]}
    text, secs, _ = run_cli("validate", *_size_args("small"), "--seconds",
                            "1")
    report = json.loads(text)
    validate = {"seconds": secs, "baseline": report["baseline"],
                "features": report["features"],
                "targets_met": report["targets_met"]}
    out = {"bench": bench, "validate": validate}
    print(f"cli bench / validate {APP['small'][0]}x{APP['small'][1]}: "
          f"{json.dumps(out)}")
    numbers = [p["fps_avg"] for p in presets] + [
        report["baseline"]["fps"]] + [f["cost_ms"] for f in
                                       report["features"]]
    if not (len(presets) == 4 and all(p["frames"] > 0 for p in presets)
            and report["baseline"]["frames"] > 0
            and all(math.isfinite(x) for x in numbers)):
        raise AssertionError(f"cli bench / validate: {out}")
    return out


def _app_info_fields(tmp):
    card, _, _ = run_cli("info")
    host, _, _ = run_cli("--device", "cpu", "info")
    a, b = json.loads(card), json.loads(host)
    out = {"info_rel": max(_rel_max(a[k], b[k]) for k in a)}
    run_cli("fields", "--out", os.path.join(tmp, "card.npz"))
    run_cli("--device", "cpu", "fields", "--out",
            os.path.join(tmp, "cpu.npz"))
    with np.load(os.path.join(tmp, "card.npz")) as c, \
            np.load(os.path.join(tmp, "cpu.npz")) as h:
        out["fields_rel"] = {k: _rel_max(c[k], h[k]) for k in c.files}
    print(f"cli info / fields card vs CPU: {json.dumps(out)}")
    if not (out["info_rel"] <= 1e-12
            and max(out["fields_rel"].values()) <= 1e-10):
        raise AssertionError(f"cli info / fields: {out}")
    return out


def phase_app():
    """Phase 20: the app on the card (see the module docstring)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"render": _app_render(tmp), "animate": _app_animate(tmp)}
        out["live"], entry = _app_live()
        out["inverse"] = _app_inverse(tmp)
        out["bench_validate"] = _app_bench_validate()
        out["info_fields"] = _app_info_fields(tmp)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 20 (app): {out['seconds']:.1f} s")
    return out, entry


# Phase 21: the multi-device layer (parallel/mesh.py, parallel/render.py,
# the mesh branches of parallel/train.py, cli sweep). World 1 runs in this
# process on NCCL, so the collectives run on the card; worlds 2 and 3 are
# spawned processes on gloo (NCCL refuses two ranks on one device) sharing
# the one card, each marching its shard on csrc/march.cu. The frames: 1080p,
# and one whose pixel-block padded count is no multiple of 3 x TILE (4,096
# zero rays at world 3 in block order, one in row-major order; the blocks
# of 1918x1078 split evenly, so it has none).
MD_SIZE = (1920, 1080)
MD_PAD_SIZE = (1922, 1078)
MD_BACKEND = "nccl"
MD_TIMEOUT = 600
MD_SWEEP_FRAMES = 4


def md_scenes(width, height):
    """The flagship scene (spectral disk, a = 0.999, 256 steps, use_pallas)
    and phase 10's jets scene."""
    return {"flagship": flagship_scene(width, height),
            "jets": scene_from_params(SimulationParams(enable_jets=True),
                                      width, height, device=DEV)}


def train_scene(width, height):
    """Phase 7's training scene (bench.py's step: the flagship camera, a =
    0.999, and MarchConfig with fused off, analytic disk)."""
    return flagship_scene(width, height, cfg=TRAIN_CFG, features=Features())


def padding_check(args):
    """The zero rays (r = 0) of a march launch's recorded arguments: the
    kernel's hit, steps and crossing count against the plain version's, per
    ray; both must be dead (hit, no step)."""
    pad = args[0][1] == 0
    n = int(pad.sum())
    with torch.no_grad():
        k = march_u(*args)
        p = march_u_plain(args[0][:, pad].contiguous(), args[1][pad],
                          *args[2:])
    kh, ks, kc = k[1][pad], k[2][pad], k[6][pad]
    ok = bool(n > 0 and torch.equal(kh, p[1]) and torch.equal(ks, p[2])
              and torch.equal(kc, p[6]) and bool((ks == 0).all())
              and bool((kh != HIT_NONE).all()))
    return {"rays": n, "ok": ok,
            "kernel_hits": sorted({int(x) for x in kh.unique()}),
            "kernel_max_steps": int(ks.max()) if n else None}


def md_steps(mesh, record=False):
    """One sharded AD step (``make_inverse_step``) and one FD step on
    phase 7's 1080p training scene from spin 0.9, zero target: losses,
    parameters, launches, and (``record``) the kernels' arguments."""
    scene = train_scene(*MD_SIZE)
    w, h = MD_SIZE
    params = InverseParams.init(spin=0.9, theta_cam=float(scene.camera.theta),
                                device=DEV)
    target = torch.zeros((h, w, 3), device=DEV)
    out = {}
    step = make_inverse_step(scene, mesh)
    if record:
        march_u.record, march_grad_kernel.record = [], []
    torch.cuda.synchronize()
    _reset_launches()
    (p1, _), loss = step(params, target)
    torch.cuda.synchronize()
    out["ad"] = {"loss": float(loss), "params": [float(x) for x in
                                                 p1.leaves()],
                 "launches": _launches()}
    if record:
        out["args"] = (march_u.record[0], march_grad_kernel.record[0])
        march_u.record = march_grad_kernel.record = None
    fd = make_fd_inverse_step(scene, mesh)
    _reset_launches()
    (vec, _), fd_loss = fd(fd_state_init(params), target)
    torch.cuda.synchronize()
    out["fd"] = {"loss": float(fd_loss), "vec": vec.tolist(),
                 "launches": _launches()}
    return out, step, (params, target)


def _md_worker(rank, world, directory, device, sizes):
    """One rank of a spawned gloo world: the sharded renders of the phase's
    scenes (1080p at world 2, the padded frame at world 3) and, at world
    2, the sharded steps. Results go to ``directory``; the parent checks
    them. ``device`` and ``sizes`` (MD_SIZE, MD_PAD_SIZE) are the
    parent's."""
    global DEV, MD_SIZE, MD_PAD_SIZE
    DEV = device
    MD_SIZE, MD_PAD_SIZE = sizes
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{directory}/init", rank=rank,
        world_size=world)
    try:
        mesh = make_mesh(device=device)
        out = {"mesh": [mesh.size, mesh.rank, mesh.backend], "renders": {}}
        size = MD_SIZE if world == 2 else MD_PAD_SIZE
        for name, scene in md_scenes(*size).items():
            march_u.record = []
            torch.cuda.synchronize()
            _reset_launches()
            img = render_sharded(scene, mesh)
            torch.cuda.synchronize()
            launches = _launches()
            args = march_u.record[0]
            march_u.record = None
            torch.save(img.cpu(), os.path.join(directory,
                                               f"{name}_{rank}.pt"))
            entry = {"launches": launches,
                     "shard_rays": int(args[0].shape[1])}
            if world == 3 and rank == world - 1:
                entry["padding"] = padding_check(args)
            if rank == 0 and world == 2 and name == "flagship":
                torch.save(args, os.path.join(directory, "march_args.pt"))
            out["renders"][name] = entry
        if world == 2:
            steps, _, _ = md_steps(mesh, record=rank == 0)
            if rank == 0:
                torch.save(steps.pop("args"),
                           os.path.join(directory, "step_args.pt"))
            out["steps"] = steps
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn_md_worlds(dirs):
    """Start the gloo worlds ({world: directory}) together and wait for
    them; a rank that raises ends the others and fails the phase, as does
    a world that outlives MD_TIMEOUT seconds."""
    import torch.multiprocessing as mp

    ctxs = [mp.start_processes(
        _md_worker, args=(n, str(d), DEV, (MD_SIZE, MD_PAD_SIZE)), nprocs=n,
        join=False, start_method="spawn") for n, d in dirs.items()]
    deadline = time.monotonic() + MD_TIMEOUT
    for ctx in ctxs:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for c in ctxs:
                    for proc in c.processes:
                        proc.kill()
                raise AssertionError(
                    f"phase 21's worlds outlived {MD_TIMEOUT} s")


def grad_entry(path, launches, m_args, g_args):
    """A kernels-line entry for a gradient-kernel launch on recorded
    arguments: the kernel alone (3 launches), and against its plain
    version at exact divides, the cotangents replayed from the exact-divide
    forward's r_min (phase 7's bars), with the bound from this run's
    steps: the replay, the re-forward and the VJP's recompute of the step
    run it as the march does (contracted on the approx route), the VJP's
    reverse (two steps' worth) is uncontracted; the bytes are the inputs
    and outputs and each live block's checkpoint (7 words) written once and
    read once (the stack stays in shared memory)."""
    cfg = g_args[6]
    grad_ms, _ = kernel_time(lambda: march_grad_kernel(*g_args), 3)
    cfg_x = dataclasses.replace(cfg, approx_recip=False)
    with torch.no_grad():
        outs = march_u(*m_args)
        k = march_u(*m_args[:6], cfg_x)
    g_x = (*g_args[:6], cfg_x, *g_args[7:12], k[7])
    gk = march_grad_kernel(*g_x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = march_grad(*g_x)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    gs = grad_compare(gk, gp)
    if not (gs["finite"] and gs["ray_p95_rel"] < 1e-2
            and gs["ray_p999_rel"] < GRAD_P999_BAR
            and gs["frac_rel_gt_1e-3"] < GRAD_TAIL_BAR
            and max(gs["partials_rel"]) < 1e-3):
        raise AssertionError(f"{path}: gradient kernel vs plain: {gs}")
    n_rays = int(outs[0].shape[1])
    total_steps = int(outs[2].long().sum())
    k_slots = cfg.max_crossings
    ops = (3 * step_ops("midpoint", cfg.approx_recip)
           + (GRAD_STEPS_PER_STEP - 3) * OPS_PER_STEP) * total_steps
    live_blocks = int(((outs[2].long() + CKPT) // CKPT).sum())
    nbytes = 4 * (n_rays * (7 + 1 + 7 + 3 * k_slots + 2 + 7 + 4)
                  + 2 * 7 * live_blocks)
    bound_ms, bound_by = bound(ops, nbytes)
    return gs, dict(
        name="march_grad", route="cuda",
        source="blackhole_simulation_tpu_torch/csrc/march_grad.cu",
        replaces="blackhole_simulation_tpu/ops/pallas_grad.py:149",
        path=path, launches=launches, max_abs_err=gs["max_abs"], ms=grad_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, rays=n_rays, steps_per_ray=total_steps / n_rays,
        ray_p95_rel=gs["ray_p95_rel"], ray_p999_rel=gs["ray_p999_rel"],
        share_of_bound=bound_ms / grad_ms)


def md_march_entry(path, launches, args):
    """march_entry on a sharded launch's recorded arguments, its plain
    version at exact divides, held to phase 17's bars."""
    plain = (*args[:6], dataclasses.replace(args[6], approx_recip=False),
             *args[7:])
    cmp, entry = march_entry(path, launches, args, plain,
                             step_ops("jets" if args[7] is not None else
                                      "midpoint", args[6].approx_recip))
    print(f"{path}: march kernel vs plain (exact divides) {cmp}")
    if not (cmp["frac_int_differ"] < 1e-3 and cmp["frac_gt_1e-4"] < 1e-3):
        raise AssertionError(f"{path}: march kernel vs plain: {cmp}")
    entry["share_of_bound"] = entry["bound_ms"] / entry["ms"]
    return entry


def _md_world_one(mesh):
    """(a): world 1 on this process's group: each 1080p scene's sharded
    frame against its single-device render, bit for bit, timed; and the
    padded frame's images for world 3."""
    out, entries, images = {}, [], {}
    w, h = MD_SIZE
    for name, scene in md_scenes(w, h).items():
        march_u.record = []
        torch.cuda.synchronize()
        _reset_launches()
        img = render_sharded(scene, mesh)
        torch.cuda.synchronize()
        launches = _launches()
        args = march_u.record[0]
        march_u.record = None
        ref_scene = single_device_twin(scene)
        ref = render(ref_scene, device=DEV)
        frame_ms, frame_min, frame_max = timed(
            lambda: render_sharded(scene, mesh), 5)
        single_ms, _, _ = timed(lambda: render(ref_scene, device=DEV), 5)
        kernel_ms, _ = kernel_time(lambda: march_u(*args), 20)
        _, prof = train_probe.profile_once(lambda: render_sharded(scene,
                                                                  mesh))
        prof["top"] = prof["top"][:6]
        res = {"bit_equal_single_device": bool(torch.equal(img, ref)),
               "launches": launches, "frame_ms": frame_ms,
               "frame_ms_min_max": [frame_min, frame_max],
               "single_device_frame_ms": single_ms, "march_ms": kernel_ms,
               "mrays_per_s": w * h / frame_ms / 1e3, "profile": prof}
        print(f"sharded render world 1 ({mesh.backend}) {name} {w}x{h}: "
              f"{json.dumps(res)}")
        if not (res["bit_equal_single_device"] and launches["march"] == 1
                and launches["render"] == 0):
            raise AssertionError(f"sharded render world 1 {name}: {res}")
        out[name] = res
        images[name] = img
        entries.append(md_march_entry(
            f"sharded render, world 1 ({mesh.backend}), {name} {w}x{h}",
            launches["march"], args))
    for name, scene in md_scenes(*MD_PAD_SIZE).items():
        images[f"{name}_pad"] = render_sharded(scene, mesh)
    return out, entries, images


def _md_sweep(mesh, tmp):
    """(d): cli sweep at its defaults but --frames: the npz frames against
    render_sharded of the director's cameras, bit for bit."""
    path = os.path.join(tmp, "sweep.npz")
    stdout, secs, launches = run_cli("sweep", "--frames",
                                     str(MD_SWEEP_FRAMES), "--out", path)
    line = json.loads(stdout.strip().splitlines()[-1])
    with np.load(path) as f:
        frames = f["frames"]
    params = SimulationParams()
    scene0 = scene_from_params(params, 480, 270, device=DEV)
    equal, args = [], None
    for i in range(MD_SWEEP_FRAMES):
        r, theta, phi = grand_survey(i * 1.0)
        cam = Camera.create(r=r, theta=theta, phi=phi, fov=params.fov,
                            width=480, height=270)
        if i == 0:
            march_u.record = []
        img = render_sharded(dataclasses.replace(scene0, camera=cam), mesh)
        if i == 0:
            args = march_u.record[0]
            march_u.record = None
        equal.append(bool(np.array_equal(frames[i], img.cpu().numpy())))
    out = {"json": line, "seconds": secs, "launches": launches,
           "frames_equal_render_sharded": equal}
    print(f"cli sweep: {json.dumps(out)}")
    if not (all(equal) and line["devices"] == 1
            and line["frames"] == MD_SWEEP_FRAMES
            and line["shape"] == [MD_SWEEP_FRAMES, 270, 480, 3]
            and launches["march"] == MD_SWEEP_FRAMES
            and launches["render"] == 0 and np.isfinite(frames).all()):
        raise AssertionError(f"cli sweep: {out}")
    return out, md_march_entry("cli sweep 480x270, world 1, frame 0",
                               launches["march"] // MD_SWEEP_FRAMES, args)


def _md_check_worlds(dirs, images, steps1):
    """(b) and (c): the spawned worlds' images against world 1's, bit for
    bit; their launches; the padding rays; the sharded steps against world
    1's at tests/test_parallel.py's bars."""
    out = {}
    for n, d in dirs.items():
        ranks = []
        for r in range(n):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        res = {"ranks": ranks}
        for name in ("flagship", "jets"):
            key = name if n == 2 else f"{name}_pad"
            ref = images[key].cpu()
            same = [torch.equal(torch.load(os.path.join(d, f"{name}_{r}.pt")),
                                ref) for r in range(n)]
            res[f"{name}_bit_equal_world_1"] = same
            bad_launch = [rk["renders"][name]["launches"] for rk in ranks
                          if rk["renders"][name]["launches"]["march"] != 1]
            if not all(same) or bad_launch:
                raise AssertionError(f"world {n} {name}: equal {same}, "
                                     f"launches {bad_launch}")
            if n == 3:
                pad = ranks[-1]["renders"][name]["padding"]
                res[f"{name}_padding"] = pad
                if not pad["ok"]:
                    raise AssertionError(f"world 3 {name} padding: {pad}")
        if n == 2:
            checks = []
            for rk in ranks:
                ad, fd = rk["steps"]["ad"], rk["steps"]["fd"]
                checks.append({
                    "ad_loss_rel": abs(ad["loss"] / steps1["ad"]["loss"] - 1),
                    "ad_spin_abs": abs(ad["params"][0]
                                       - steps1["ad"]["params"][0]),
                    "ad_params_abs": max(abs(x - y) for x, y in zip(
                        ad["params"], steps1["ad"]["params"])),
                    "fd_loss_rel": abs(fd["loss"] / steps1["fd"]["loss"] - 1),
                    "fd_vec_abs": max(abs(x - y) for x, y in zip(
                        fd["vec"], steps1["fd"]["vec"])),
                    "ad_launches": ad["launches"],
                    "fd_launches": fd["launches"]})
            res["steps"] = checks
            for c in checks:
                if not (c["ad_loss_rel"] < 1e-4 and c["ad_spin_abs"] < 5e-5
                        and c["fd_loss_rel"] < 1e-4
                        and c["fd_vec_abs"] < 5e-4
                        and c["ad_launches"]["march"] == 1
                        and c["ad_launches"]["march_grad"] == 1
                        and c["fd_launches"]["march"] == 9):
                    raise AssertionError(f"world 2 sharded steps: {c}")
        print(f"world {n} (gloo, one card): {json.dumps(res)}")
        out[n] = res
    return out


def phase_multi_device():
    """Phase 21: the multi-device layer (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group(
            MD_BACKEND, init_method=f"file://{tmp}/init1", rank=0,
            world_size=1)
        try:
            mesh = make_mesh(device=DEV)
            if not (mesh.group is not None and mesh.size == 1
                    and mesh.backend == MD_BACKEND):
                raise AssertionError(f"world-1 mesh: {mesh}")
            out["world1"], entries, images = _md_world_one(mesh)
            steps1, step, step_in = md_steps(mesh)
            step_ms, step_min, step_max = timed(lambda: step(*step_in), 3)
            steps1["ad"]["step_ms"] = step_ms
            steps1["ad"]["step_ms_min_max"] = [step_min, step_max]
            out["steps_world1"] = steps1
            print(f"sharded steps world 1 ({MD_BACKEND}): "
                  f"{json.dumps(steps1)}")
            out["sweep"], sweep_entry = _md_sweep(mesh, tmp)
            dirs = {}
            for n in (2, 3):
                dirs[n] = os.path.join(tmp, f"world{n}")
                os.makedirs(dirs[n])
            t_spawn = time.perf_counter()
            spawn_md_worlds(dirs)
            out["spawned_worlds_seconds"] = time.perf_counter() - t_spawn
            out["worlds"] = _md_check_worlds(dirs, images, steps1)
            w2 = dirs[2]
            m_args = torch.load(os.path.join(w2, "march_args.pt"),
                                map_location=DEV, weights_only=False)
            entries.append(md_march_entry(
                f"sharded render, world 2 (gloo), rank 0's shard, flagship "
                f"{MD_SIZE[0]}x{MD_SIZE[1]}",
                out["worlds"][2]["ranks"][0]["renders"]["flagship"]
                ["launches"]["march"], m_args))
            sm_args, sg_args = torch.load(os.path.join(w2, "step_args.pt"),
                                          map_location=DEV,
                                          weights_only=False)
            rank0 = out["worlds"][2]["ranks"][0]["steps"]["ad"]["launches"]
            entries.append(md_march_entry(
                "sharded AD step, world 2 (gloo), rank 0's shard",
                rank0["march"], sm_args))
            gs, g_entry = grad_entry(
                "sharded AD step, world 2 (gloo), rank 0's shard",
                rank0["march_grad"], sm_args, sg_args)
            print(f"sharded AD step gradient kernel vs plain: {gs}")
            entries += [sweep_entry, g_entry]
        finally:
            torch.distributed.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 21 (multi-device): {out['seconds']:.1f} s")
    return out, entries


# Phase 22: the differentiable render. The flagship physics on the staged
# route, which the JAX package differentiates (use_pallas=False); its
# kernels run the exact midpoint march (render/march.py::_kernel_cfg).
AD_CFG = dataclasses.replace(FLAGSHIP_CFG, use_pallas=False, fused=False)
AD_FRAMES = 5
AD_CROP = 64
# The CPU test's near-critical rays (tests/test_torch_ad_crossings.py): one
# pixel of a 64x64 frame at a = 0.9, at sub-pixel offsets about its
# critical point, 512 steps at step rate 0.05: 3 to 6 crossings each.
K8_PIX = 32 * 64 + 59
K8_CRIT = 0.490541473031044
K8_CFG = MarchConfig(max_steps=512, step_rate=0.05, max_crossings=8)


def leaf_scene(scene, dtype=torch.float32):
    """``scene`` with its seven data leaves (mass, spin, the camera's r,
    theta, phi, fov, roll) as 0-d ``dtype`` tensors on the card that
    require grad: (scene, leaves)."""
    t = lambda v: torch.tensor(float(v), dtype=dtype, device=DEV,
                               requires_grad=True)
    cam = scene.camera
    names = ("r", "theta", "phi", "fov", "roll")
    leaves = [t(scene.bh.mass), t(scene.bh.spin)] + [
        t(getattr(cam, k)) for k in names]
    return dataclasses.replace(
        scene, bh=dataclasses.replace(scene.bh, mass=leaves[0],
                                      spin=leaves[1]),
        camera=dataclasses.replace(cam, **dict(zip(names, leaves[2:])))
    ), leaves


def grad_ops(total_steps, jets):
    """The gradient kernel's counted operations on the exact route (phase
    7's count) and, with jets, the emission's recompute and its reverse
    (about twice the forward term) at every live step."""
    ops = (3 * step_ops("midpoint", False)
           + (GRAD_STEPS_PER_STEP - 3) * OPS_PER_STEP)
    if jets:
        ops += 3 * OPS_PER_STEP_JETS
    return ops * total_steps


# Phase 22(d)'s gradient bars in place of phase 7's per-ray tail: its rays
# march 512 steps at step rate 0.05 about a critical point, twice phase
# 7's 256 and more chaotic, and its first run on the card put 10 of 4,096
# rays above rel 1e-3 (the worst at 4.1e-3) with the summed partials
# within 7e-5: every ray within rel 1e-2 instead.
K8_GRAD_MAX_REL = 1e-2


def grad_kernel_entry(path, launches, args, steps, jets, max_rel=None,
                      **extra):
    """A kernels-line entry for the gradient kernel on ``args``: the kernel
    alone (3 launches) and its plain version once, phase 7's bars (or,
    with ``max_rel``, every ray's worst row within it in place of the
    per-ray tail), the bound from this run's live steps (``steps``)."""
    ms, gk = kernel_time(lambda: march_grad_kernel(*args), 3)
    t0 = time.perf_counter()
    gp = march_grad(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    gs = grad_compare(gk, gp)
    tail = (gs["max_rel"] < max_rel if max_rel is not None else
            gs["ray_p999_rel"] < GRAD_P999_BAR
            and gs["frac_rel_gt_1e-3"] < GRAD_TAIL_BAR)
    if not (gs["finite"] and gs["ray_p95_rel"] < 1e-2 and tail
            and max(gs["partials_rel"]) < 1e-3):
        raise AssertionError(f"{path}: gradient kernel vs plain: {gs}")
    n_rays = int(args[0].shape[1])
    k_slots = args[6].max_crossings
    live_blocks = int(((steps.long() + CKPT) // CKPT).sum())
    nbytes = 4 * (n_rays * (7 + 1 + 7 + 3 * k_slots + 2 + 7 + 4
                            + (3 if jets else 0)) + 2 * 7 * live_blocks)
    bound_ms, bound_by = bound(grad_ops(int(steps.long().sum()), jets),
                               nbytes)
    return gs, dict(
        name="march_grad", route="cuda",
        source="blackhole_simulation_tpu_torch/csrc/march_grad.cu",
        replaces="blackhole_simulation_tpu/ops/pallas_grad.py:149",
        path=path, launches=launches, max_abs_err=gs["max_abs"], ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, rays=n_rays,
        steps_per_ray=float(steps.float().mean()),
        ray_p95_rel=gs["ray_p95_rel"], ray_p999_rel=gs["ray_p999_rel"],
        share_of_bound=bound_ms / ms, **extra)


def ad_frames(scene, dtype=torch.float32):
    """(b) for one scene at 1080p: the AD frame's times, launches,
    gradients and the gradient kernel's recorded arguments; rendered in
    ``dtype`` (phase 23 asks for float64)."""
    sc, leaves = leaf_scene(scene, dtype)

    def frame():
        return torch.autograd.grad(
            render_radiance(sc, dtype=dtype).mean(), leaves)

    frame()                                  # builds the tables' graph once
    march_u.record, march_grad_kernel.record = [], []
    grads = frame()
    torch.cuda.synchronize()
    m_args, g_args = march_u.record[0], march_grad_kernel.record[0]
    march_u.record = march_grad_kernel.record = None
    march_u.launches = march_grad_kernel.launches = 0
    render_planes_kernel.launches = 0
    fb = timed(frame, AD_FRAMES)
    launches = {"march": march_u.launches,
                "march_grad": march_grad_kernel.launches,
                "render": render_planes_kernel.launches}
    fwd = timed(lambda: render_radiance(sc, dtype=dtype), AD_FRAMES)
    with torch.no_grad():
        fwd_nograd = timed(lambda: render_radiance(sc, dtype=dtype),
                           AD_FRAMES)
    grads = [float(g) for g in grads]
    if launches != {"march": AD_FRAMES, "march_grad": AD_FRAMES,
                    "render": 0}:
        raise AssertionError(f"AD frames' launches: {launches}")
    if not all(math.isfinite(g) for g in grads):
        raise AssertionError(f"AD frame gradients not finite: {grads}")
    return {"fwd_bwd_ms": fb[0], "fwd_bwd_ms_min_max": list(fb[1:]),
            "fwd_ms": fwd[0], "fwd_ms_nograd": fwd_nograd[0],
            "launches_per_frame": {"march": 1, "march_grad": 1},
            "grads": dict(zip(("mass", "spin", "r", "theta", "phi", "fov",
                               "roll"), grads))}, m_args, g_args


def jets_crop_args(dtype=torch.float32):
    """(a)'s gradient-kernel arguments, recorded from a differentiable
    render of the 64x64 crop of phase 10's 1080p jets scene where most
    rays pass through the jets' cone (the whole frame's jets march picks
    it): the AD route's march (the exact midpoint march; jets turn the
    precull off) and the composite of the crop's rays, the mean radiance's
    gradient in mass and spin, so that the kernel gets a real loss's
    cotangents, as phase 7's does; the crop's rays in ``dtype``. Returns
    (arguments, the crop's march outputs)."""
    scene = scene_from_params(SimulationParams(enable_jets=True), 1920, 1080)
    cfg = dataclasses.replace(scene.march_cfg, shadow_precull=False)
    kcfg = _kernel_cfg(cfg, scene.jet_params)
    m, a = _cuda_scalar(float(scene.bh.mass)), _cuda_scalar(
        float(scene.bh.spin))
    with torch.no_grad():
        frame = march_u(*_march_inputs(camera_rays_u(scene.camera, m, a),
                                       m, a, kcfg, None), kcfg,
                        scene.jet_params)
    lit = (frame[8].abs().sum(0) > 0).float().reshape(1, 1, 1080, 1920)
    share = torch.nn.functional.avg_pool2d(lit, AD_CROP, stride=AD_CROP // 2)
    by, bx = divmod(int(share.reshape(-1).argmax()), share.shape[-1])
    y0, x0 = by * AD_CROP // 2, bx * AD_CROP // 2
    ys, xs = torch.meshgrid(torch.arange(AD_CROP), torch.arange(AD_CROP),
                            indexing="ij")
    ids = ((ys + y0) * 1920 + xs + x0).reshape(-1).to(DEV)
    m, a = (_cuda_scalar(float(scene.bh.mass), True, dtype),
            _cuda_scalar(float(scene.bh.spin), True, dtype))
    rays = camera_rays_u(scene.camera, m, a, pix_ids=ids, dtype=dtype)
    march_u.record, march_grad_kernel.record = [], []
    rows = march_rows(rays, m, a, cfg, jets=scene.jet_params)
    rgb = shade_march_rows(rows, m, a, scene, conserved_lam(rays))
    torch.autograd.grad(torch.stack(rgb).mean(), (m, a))
    m_args, g_args = march_u.record[0], march_grad_kernel.record[0]
    march_u.record = march_grad_kernel.record = None
    if g_args[14] is None or g_args[6].approx_recip:
        raise AssertionError("the jets crop's gradient kernel took the "
                             "wrong instantiation")
    with torch.no_grad():
        outs = march_u(*m_args)
    return g_args, outs


def ad_gates(width=48, height=32, dtype=torch.float32):
    """(c) the oracle gradient gates for spin and theta through
    ``render_radiance`` in ``dtype`` (phase 14's frames and param_gate)."""
    base = gate_scene(0.999, width, height, turbulence=0.0)

    def ad_grad(field):
        def grad(p0, weights):
            leaf = _cuda_scalar(p0, grad=True, dtype=dtype)
            if field == "spin":
                sc = dataclasses.replace(base, bh=dataclasses.replace(
                    base.bh, spin=leaf))
            else:
                sc = dataclasses.replace(base, camera=dataclasses.replace(
                    base.camera, theta=leaf))
            rgb = render_radiance(fine(sc), dtype=dtype)
            return float(torch.autograd.grad(torch.sum(rgb * weights),
                                             leaf)[0])
        return grad

    return {
        "spin": param_gate("spin", gate_oracle_images("spin", base),
                           ad_grad("spin"), 0.999, 5e-4, width, height),
        "theta_cam": param_gate(
            "theta_cam", gate_oracle_images("theta_cam", base),
            ad_grad("theta_cam"), float(base.camera.theta), 2e-3, width,
            height),
    }


def k8_checks():
    """(d) each kernel's KMAX = 8 build against its plain version on the
    near-critical rays, driven through the entry points (the staged
    sample under autograd, the fused sample) with the counts reset."""
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5, width=64,
                        height=64)
    base = Scene.create(mass=1.0, spin=0.9, camera=cam, march_cfg=K8_CFG)
    jitter = np.asarray((K8_CRIT, 0.0), np.float32)
    sc, leaves = leaf_scene(base)
    march_u.launches = march_grad_kernel.launches = 0
    render_planes_kernel.launches = 0
    march_u.record, march_grad_kernel.record = [], []
    rgb = render_sample(sc, jitter, DEV)
    grads = torch.autograd.grad(rgb.mean(), leaves)
    fused = dataclasses.replace(base, march_cfg=dataclasses.replace(
        K8_CFG, use_pallas=True, fused=True))
    planes = render_sample(fused, jitter, DEV)
    torch.cuda.synchronize()
    launches = {"march": march_u.launches,
                "march_grad": march_grad_kernel.launches,
                "render": render_planes_kernel.launches}
    m_args, g_args = march_u.record[0], march_grad_kernel.record[0]
    march_u.record = march_grad_kernel.record = None
    if launches != {"march": 1, "march_grad": 1, "render": 1}:
        raise AssertionError(f"K = 8 launches: {launches}")
    if not (all(math.isfinite(float(g)) for g in grads)
            and bool(torch.isfinite(planes).all())):
        raise AssertionError("K = 8 render not finite")
    # the march kernel on the critical sweep's rays and on the frame's
    m, a = _cuda_scalar(1.0), _cuda_scalar(0.9)
    rays = torch.cat([camera_rays_u(cam, m, a, pix_ids=torch.tensor(
        [K8_PIX], device=DEV), jitter=(K8_CRIT + d, 0.0))
        for d in (-1e-4, -1e-6, -1e-8, 0.0, 3e-14, 1e-8, 1e-6, 1e-4)], 1)
    sweep = _march_inputs(rays, m, a, K8_CFG, None)
    with torch.no_grad():
        k_sweep = march_u(*sweep, K8_CFG)
        p_sweep = march_u_plain(*sweep, K8_CFG)
    s_cmp = march_compare(k_sweep, p_sweep)
    max_nc = int(k_sweep[6].max())
    cmp, march_e = march_entry(
        "K = 8 staged sample 64x64 (near-critical pixel)",
        launches["march"], m_args, m_args, step_ops("midpoint", False),
        variant="midpoint KMAX 8", registers_spill=list(
            next((r, sp) for e, r, sp in kbuild.ptxas_usage("march.cu", 8)
                 if "ILi0ELb0E" in e)))
    # phase 5's bars: the integers equal, the floats within 1e-4
    if not (max_nc > 4 and s_cmp["frac_int_differ"] == 0.0
            and s_cmp["max_abs"] < 1e-4 and cmp["frac_int_differ"] == 0.0
            and cmp["max_abs"] < 1e-4):
        raise AssertionError(f"K = 8 march kernel vs plain: {cmp}, sweep "
                             f"{s_cmp}, max crossings {max_nc}")
    # the render kernel at the critical offset, exact route: phase 10's
    # bars (bit-equal is the aim)
    row, st = kernel_inputs(fused, jitter, DEV)
    steps = torch.empty((64, 64), dtype=torch.int32, device=DEV)
    k = render_planes_kernel(row, st, steps)
    r_ms, _ = kernel_time(lambda: render_planes_kernel(row, st), 20)
    t0 = time.perf_counter()
    pl = render_planes(row, st)
    torch.cuda.synchronize()
    r_plain_ms = (time.perf_counter() - t0) * 1e3
    r_cmp = diff_stats(k, pl)
    r_cmp["bit_equal"] = r_cmp["max_abs"] == 0.0
    if not (r_cmp["p99_abs"] < 1e-4 and r_cmp["mean_abs"] < 1e-5):
        raise AssertionError(f"K = 8 render kernel vs plain: {r_cmp}")
    total = int(steps.long().sum())
    r_bound, r_by = bound(step_ops("midpoint", False) * total
                          + OPS_PER_PIXEL * 64 * 64,
                          12 * 64 * 64 + 4 * row.numel())
    render_e = {
        "name": "render", "route": "cuda",
        "source": "blackhole_simulation_tpu_torch/csrc/render.cu",
        "replaces": "blackhole_simulation_tpu/ops/pallas_render.py:140",
        "path": "K = 8 fused sample 64x64 (near-critical pixel)",
        "variant": "midpoint KMAX 8", "launches": launches["render"],
        "max_abs_err": r_cmp["max_abs"], "ms": r_ms, "plain_ms": r_plain_ms,
        "bound_ms": r_bound, "bound_by": r_by, "library_ms": None,
        "steps_sum": total, "registers_spill": list(next(
            (r, sp) for e, r, sp in kbuild.ptxas_usage("render.cu", 8)
            if "ILi0ELb0ELb0E" in e))}
    gs, grad_e = grad_kernel_entry(
        "K = 8 staged sample 64x64 under autograd", launches["march_grad"],
        g_args, march_u(*m_args)[2], False, max_rel=K8_GRAD_MAX_REL,
        variant="exact KMAX 8")
    print(f"K = 8: launches {launches}; max crossings {max_nc}; sweep "
          f"{s_cmp}; march {cmp}; render {r_cmp}; gradient {gs}")
    return {"launches": launches, "max_crossings": max_nc,
            "sweep_vs_plain": s_cmp, "march_vs_plain": cmp,
            "render_vs_plain": r_cmp, "gradient_vs_plain": gs}, [
        march_e, render_e, grad_e]


def phase_ad_render():
    """Phase 22: the differentiable render (see the module docstring)."""
    t0 = time.perf_counter()
    out, entries = {}, []
    # (b) the 1080p AD frames
    for name, feats in (("flagship", Features(spectral_lut=True)),
                        ("jets", Features(spectral_lut=True, jets=True))):
        scene = flagship_scene(1920, 1080, cfg=AD_CFG, features=feats)
        info, m_args, g_args = ad_frames(scene)
        jets = feats.jets
        if (g_args[14] is not None) != jets or g_args[6].approx_recip:
            raise AssertionError(f"{name}: the AD frame's gradient kernel "
                                 "took the wrong instantiation")
        g_ms, _ = kernel_time(lambda: march_grad_kernel(*g_args), 3)
        steps = march_u(*m_args)[2]
        g_bound, g_by = bound(grad_ops(int(steps.long().sum()), jets), 0)
        marker = "ILb0ELb1E" if jets else "ILb0ELb0E"
        info.update(grad_kernel_ms=g_ms, grad_bound_ms=g_bound,
                    grad_bound_by=g_by,
                    grad_registers_spill=list(registers("march_grad.cu",
                                                        marker)),
                    grad_resident_warps_per_sm=grad_kernel_shape(
                        False, jets)["warps_per_sm"],
                    steps_per_ray=float(steps.float().mean()))
        print(f"AD {name} render_radiance 1920x1080: forward + backward "
              f"{info['fwd_bwd_ms']:.1f} ms (median of {AD_FRAMES}), forward "
              f"{info['fwd_ms']:.1f} ms ({info['fwd_ms_nograd']:.1f} without "
              f"grad); gradient kernel {g_ms:.3f} ms, bound {g_bound:.3f} "
              f"ms, registers/spill {info['grad_registers_spill']}; "
              f"gradients {info['grads']}")
        parent_gate(f"AD {name} gradient", g_ms)
        if name == "flagship":
            gs, entry = grad_kernel_entry(
                "AD flagship render_radiance 1920x1080",
                AD_FRAMES, g_args, steps, False, variant="exact",
                registers_spill=info["grad_registers_spill"])
            info["grad_vs_plain"] = gs
            entries.append(entry)
        else:
            jets_launches, jets_1080 = AD_FRAMES, info
        out[name] = info
    # (a) the jets instantiation against its plain version on the crop
    args, outs = jets_crop_args()
    gs, entry = grad_kernel_entry(
        "jets gradient, 64x64 crop of the 1080p jets scene", jets_launches,
        args, outs[2], True, variant="exact jets",
        registers_spill=jets_1080["grad_registers_spill"],
        ms_1080p=jets_1080["grad_kernel_ms"],
        bound_ms_1080p=jets_1080["grad_bound_ms"],
        bound_by_1080p=jets_1080["grad_bound_by"],
        jet_rays=int((outs[8].abs().sum(0) > 0).sum()))
    print(f"jets gradient kernel vs plain (64x64 crop, {entry['jet_rays']} "
          f"of its rays through the jets): {gs}")
    if entry["jet_rays"] < AD_CROP * AD_CROP // 8:
        raise AssertionError(f"the jets crop has {entry['jet_rays']} rays "
                             "through the jets")
    out["jets_crop"] = gs
    entries.append(entry)
    # (c) the oracle gradient gates through render_radiance
    out["gates"] = ad_gates()
    # (d) eight crossings
    out["k8"], k8_entries = k8_checks()
    entries += k8_entries
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 22 (differentiable render): {out['seconds']:.1f} s")
    return out, entries


# Phase 23: the float64 render. The published FP64 rate of the H100 SXM
# outside the tensor cores (33.5 TFLOP/s, an FMA counted as two, half the
# FP32 rate above), in lane FMAs: every float64 kernel's operation bound
# divides its counted operations by it (one lane instruction each, as the
# float bounds count them).
FP64_PEAK = 33.5e12
FP64_LANE_PEAK = FP64_PEAK / 2
# The float64 march on phase 22's staged flagship route, exact divides
# (the JAX package's float64 jnp march divides exactly).
F64_CFG = dataclasses.replace(AD_CFG, approx_recip=False)
# (a)'s bar: the hit, steps and crossing counts equal, and every float of
# the kernel within 1e-12 of the plain version's (float32's bar is 1e-4).
# The first run on the card was bit-equal in every variant but for 15 of
# the jets' radiance values, an ulp of CUDA's exp or pow apart.
F64_MARCH_BAR = 1e-12
# (b)'s bars: the 95th percentile of the initial rows' relative difference
# from the plain VJP, the 99.9th of each ray's worst row, and each summed
# partial's relative difference (float32's: 1e-2, 2e-3 and 1e-3). The
# kernel's hand-written adjoint and autograd's add the same terms in
# another order, so the two part by the chaotic rays' growth of an ulp.
F64_GRAD_P95_BAR = 1e-9
F64_GRAD_P999_BAR = 1e-7
F64_GRAD_PARTIALS_BAR = 1e-8
# Phase 7's recorded rays, sampled for the float64 plain VJP (a seeded
# subset: the plain version's cost is its per-step host work).
F64_GRAD_RAYS = 65536
# (d): the fused float64 frame, its row built in float64, against the CPU
# port's plain version on the same row (exact route: bit-equal is the aim).
F64_FUSED_SIZE = (160, 90)
# (e): the sharded render under autograd. A frame whose tone map has no
# exactly black pixel (x^(1/2.2) at 0 has an infinite derivative, NaN in
# both packages): bloom over the whole frame (threshold 0, 12 passes,
# exposure 3). The relative bar of each leaf's gradient against the
# single-device twin's: the shards sum their rays' partials in another
# order than one launch does.
F64_MD_SIZE = (480, 270)
F64_MD_POST = dict(exposure=3.0, bloom_threshold=0.0, bloom_passes=12)
F64_MD_REL = {torch.float32: 1e-4, torch.float64: 1e-10}


def bound64(ops, nbytes):
    """``bound`` at the card's published FP64 rate."""
    ops_ms = ops / FP64_LANE_PEAK * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def march_f64_compare(k, p):
    """(a)'s comparison: the integers' disagreements and the floats'
    largest |d| (state, records, r_min, jets)."""
    ints = sum(int((k[i] != p[i]).sum()) for i in (1, 2, 6))
    d = max(float((k[i] - p[i]).abs().max()) for i in (0, 3, 4, 5, 7, 8))
    n_differ = sum(int((k[i] != p[i]).sum()) for i in (0, 3, 4, 5, 7, 8))
    return {"int_differ": ints, "max_abs": d, "floats_differ": n_differ}


def march_f64_entry(path, launches, args, variant, marker, kmax=4,
                    bit_equal=False):
    """A kernels-line entry for a float64 march instantiation on ``args``:
    the kernel alone, its plain version once, (a)'s bar (``bit_equal``:
    every output the plain version's bits), the FP64 bound."""
    with torch.no_grad():
        ms, k = kernel_time(lambda: march_u(*args), 5)
        t0 = time.perf_counter()
        p = march_u_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    cmp = march_f64_compare(k, p)
    if bit_equal:
        cmp["bit_identical"] = march_census.outputs_identical(k, p)
    if not (cmp["int_differ"] == 0 and cmp["max_abs"] <= F64_MARCH_BAR
            and cmp.get("bit_identical", True)):
        raise AssertionError(f"{path}: float64 march kernel vs plain: {cmp}")
    cfg, jets = args[6], args[7] if len(args) > 7 else None
    n_rays = int(k[0].shape[1])
    steps = k[2].long()
    k_slots = cfg.max_crossings
    nbytes = 8 * n_rays * (9 + 8 + 3 * k_slots + 1 + 3) + 4 * 3 * n_rays
    b_ms, b_by = bound64(step_ops(variant.split()[0], False)
                         * int(steps.sum()), nbytes)
    regs = next((r, sp) for e, r, sp in kbuild.ptxas_usage("march.cu", kmax)
                if marker in e)
    return cmp, dict(
        name="march", route="cuda",
        source="blackhole_simulation_tpu_torch/csrc/march.cu",
        replaces="blackhole_simulation_tpu/ops/pallas_march.py:646",
        path=path, variant=f"float64 {variant}", launches=launches,
        max_abs_err=cmp["max_abs"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, rays=n_rays,
        steps_sum=int(steps.sum()), steps_per_ray=float(steps.float().mean()),
        registers_spill=list(regs), resident_warps_per_sm=march_kernel_shape(
            cfg, jets, F64)["warps_per_sm"], share_of_bound=b_ms / ms)


def grad_f64_bound(args, steps, jets):
    """(bound_ms, bound_by) of the float64 gradient on ``args`` at the FP64
    rate: the counted operations of this run's live steps, and the bytes:
    the inputs and outputs, each live block's checkpoint (7 words) and each
    ray's count of live blocks, written once and read once (the tape stays
    in shared memory)."""
    n_rays = int(args[0].shape[1])
    k_slots = args[6].max_crossings
    blocks = ((steps.long() + CKPT_F64 - 1) // CKPT_F64).clamp(min=1)
    nbytes = 8 * (n_rays * (7 + 1 + 7 + 3 * k_slots + 2 + 7 + 4
                            + (3 if jets else 0) + 2)
                  + 2 * 7 * int(blocks.sum()))
    return bound64(grad_ops(int(steps.long().sum()), jets), nbytes)


def grad_f64_entry(path, launches, args, steps, jets, **extra):
    """A kernels-line entry for a float64 gradient instantiation on
    ``args``: the kernel alone, the plain VJP once, (b)'s bars, the FP64
    bound, the launch shape (the reverse kernel's and the replay kernel's
    warps per SM), the lane efficiency of the reverse kernel's warps
    (counted by ``tools/grad_census.py``'s lane-counting copy, built in
    phase 1) beside one thread per ray's on the same rays, and the SASS
    census of its reverse loop."""
    ms, gk = kernel_time(lambda: march_grad_kernel(*args), 3)
    t0 = time.perf_counter()
    gp = march_grad(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    gs = grad_compare(gk, gp)
    if not (gs["finite"] and gs["ray_p95_rel"] < F64_GRAD_P95_BAR
            and gs["ray_p999_rel"] < F64_GRAD_P999_BAR
            and max(gs["partials_rel"]) < F64_GRAD_PARTIALS_BAR):
        raise AssertionError(f"{path}: float64 gradient kernel vs plain: "
                             f"{gs}")
    n_rays = int(args[0].shape[1])
    b_ms, b_by = grad_f64_bound(args, steps, jets)
    marker = "f64ILb1E" if jets else "f64ILb0E"
    shape = grad_kernel_shape(False, jets, F64)
    label = f"march_grad_kernel_f64<{int(jets)}>"
    reverse = sass_census.reverse_census(
        sass_census.sass(kbuild.build("march_grad.cu")))[label]
    return gs, dict(
        name="march_grad", route="cuda",
        source="blackhole_simulation_tpu_torch/csrc/march_grad.cu",
        replaces="blackhole_simulation_tpu/ops/pallas_grad.py:149",
        path=path, variant="float64 jets" if jets else "float64",
        launches=launches, max_abs_err=gs["max_abs"], ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        rays=n_rays, steps_per_ray=float(steps.float().mean()),
        ray_p95_rel=gs["ray_p95_rel"], ray_p999_rel=gs["ray_p999_rel"],
        registers_spill=list(registers("march_grad.cu", marker)),
        replay_registers_spill=list(registers("march_grad.cu",
                                              "march_replay_kernel_f64")),
        smem_bytes=shape["smem_bytes"], ckpt=shape["ckpt"],
        resident_warps_per_sm=shape["warps_per_sm"],
        replay_warps_per_sm=shape["replay"]["warps_per_sm"],
        lane_efficiency=grad_census.lane_efficiency(LANE_COUNT_LIB, args),
        lane_efficiency_one_per_thread=grad_census.block_lane_efficiency(
            steps, CKPT_F64),
        reverse_loop_census={"total": reverse["total"],
                             "counts": reverse["counts"]},
        share_of_bound=b_ms / ms, **extra)


def f64_march_variants(entries):
    """(a) the float64 AB3 march against its plain version on the 1080p
    flagship staged rays, reached through ``march_u`` alone (no float64
    render marches AB3: the JAX package raises there). The midpoint and
    jets instantiations are held on (c)'s frames, the KMAX 8 build in
    ``f64_k8``."""
    out = {}
    cam = _camera(1920, 1080)
    m, a = _f64(1.0), _f64(0.999)
    rays = camera_rays_u(cam, m, a, dtype=F64)
    cfg = dataclasses.replace(F64_CFG, multistep=True)
    args = _march_inputs(rays, m, a, cfg, None) + (cfg, None)
    march_u.launches = 0
    with torch.no_grad():
        march_u(*args)
    torch.cuda.synchronize()
    cmp, e = march_f64_entry("march_u, float64 rays, AB3 1920x1080",
                             march_u.launches, args, "ab3", "f64ILi1E",
                             bit_equal=True)
    loop = sass_census.census(sass_census.sass(kbuild.build("march.cu")))[
        march_census.AB3_LABEL]
    e.update(
        stack_frame_bytes=next(v for k, v in kbuild.ptxas_stack(
            "march.cu").items() if "f64ILi1E" in k),
        smem_bytes=march_kernel_shape(cfg, None, F64)["smem_bytes"],
        lane_efficiency=march_census.counted_lane_efficiency(
            MARCH_COUNT_LIB, args),
        lane_efficiency_one_per_thread=lane_efficiency(
            march_u(*args)[2]),
        step_loop_census={"total": loop["total"], "local": loop["local"],
                          "counts": loop["counts"]})
    # the launch alone, without march_u's prologue (normalize_pt's copy of
    # the rows, the outputs' allocation, the jets rows' zeroing)
    lib = march_census.MarchLib(kbuild.build("march.cu"))
    t = lib.prepare(args)
    e["kernel_ms"] = grad_census.event_ms(lambda: lib.launch(t), 5)
    print(f"float64 AB3 march 1920x1080: {e['ms']:.3f} ms through march_u, "
          f"{e['kernel_ms']:.3f} ms the launch alone (bound "
          f"{e['bound_ms']:.3f}), registers/spill {e['registers_spill']}, "
          f"stack frame {e['stack_frame_bytes']} B, "
          f"{e['smem_bytes']} B shared per block, "
          f"{e['resident_warps_per_sm']} warps per SM, lane efficiency "
          f"{e['lane_efficiency']:.4f}, step loop {loop['total']} "
          f"instructions, local {loop['local']}; vs plain {cmp}")
    parent_gate("float64 AB3 march", e["ms"])
    out["ab3"] = cmp
    entries.append(e)
    return out


def f64_k8(entries):
    """(a) and (b) on the KMAX 8 build: the float64 staged sample of
    phase 22(d)'s near-critical 64x64 frame under autograd (one march and
    one gradient launch), each kernel against its plain version."""
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5, width=64,
                        height=64)
    base = Scene.create(mass=1.0, spin=0.9, camera=cam, march_cfg=K8_CFG)
    jitter = np.asarray((K8_CRIT, 0.0), np.float64)
    sc, leaves = leaf_scene(base, F64)
    march_u.launches = march_grad_kernel.launches = 0
    march_u.record, march_grad_kernel.record = [], []
    rgb = render_sample(sc, jitter, DEV, F64)
    grads = torch.autograd.grad(rgb.mean(), leaves)
    torch.cuda.synchronize()
    launches = {"march": march_u.launches,
                "march_grad": march_grad_kernel.launches}
    m_args, g_args = march_u.record[0], march_grad_kernel.record[0]
    march_u.record = march_grad_kernel.record = None
    if (launches != {"march": 1, "march_grad": 1} or rgb.dtype != F64
            or not all(math.isfinite(float(g)) for g in grads)):
        raise AssertionError(f"float64 K = 8: {launches}, {rgb.dtype}")
    cmp, e = march_f64_entry("float64 K = 8 staged sample 64x64 "
                             "(near-critical pixel)", 1, m_args,
                             "midpoint KMAX 8", "f64ILi0E", kmax=8)
    with torch.no_grad():
        steps = march_u(*m_args)[2]
    # (the gradient kernel has no crossing slots: K = 8 is its default
    # build)
    gs, ge = grad_f64_entry("float64 K = 8 staged sample 64x64 under "
                            "autograd", 1, g_args, steps, False)
    entries += [e, ge]
    return {"launches": launches, "march_vs_plain": cmp,
            "gradient_vs_plain": gs, "max_crossings": int(steps.max())}


def f64_phase7_grad():
    """(b) the float64 gradient instantiation on phase 7's recorded
    inputs cast to float64 (a seeded sample of F64_GRAD_RAYS rays, exact
    route), its forward's r_min from the float64 march."""
    m_args, g_args = RECORDED["training"]
    n = int(m_args[0].shape[1])
    gen = torch.Generator(device="cpu").manual_seed(0)
    idx = torch.randperm(n, generator=gen)[:F64_GRAD_RAYS].to(DEV)
    cfg = dataclasses.replace(g_args[6], approx_recip=False)
    d = lambda x: x.detach().to(F64)
    yt0, thr = d(g_args[0][:, idx]), d(g_args[1][idx])
    scal = [d(torch.as_tensor(x)) for x in g_args[2:6]]
    with torch.no_grad():
        k = march_u(yt0, thr, *scal, cfg)
    args = (yt0, thr, *scal, cfg, d(g_args[7][:, idx]),
            *(d(x[:, idx]) for x in g_args[8:11]), d(g_args[11][idx]),
            k[7], None, None)
    gs, e = grad_f64_entry("phase 7's recorded training-step rays, cast to "
                           f"float64 ({F64_GRAD_RAYS} of them)", 0, args,
                           k[2], False)
    gs.update(ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"])
    print(f"float64 gradient kernel vs plain on phase 7's rays: {gs}")
    return gs


def f64_fused():
    """(d) the fused float64 flagship frame: float32 planes from the
    render kernel on the row built in float64 (mass and spin unrounded),
    against the CPU port's plain version on the same row (exact route),
    and that row against the float32 route's."""
    w, h = F64_FUSED_SIZE
    cfg = dataclasses.replace(FLAGSHIP_CFG, approx_recip=False)
    scene = flagship_scene(w, h, cfg=cfg)
    render_planes_kernel.launches = 0
    img = render_radiance(scene, dtype=F64)
    img32 = render_radiance(scene)
    torch.cuda.synchronize()
    launches = render_planes_kernel.launches
    row, st = kernel_inputs(scene, None, DEV, F64)
    row32, _ = kernel_inputs(scene, None, DEV)
    k = render_planes_kernel(row, st)
    p = render_planes(row.cpu(), st)
    d = (k.cpu() - p).abs()
    out = {"dtype": str(img.dtype), "launches": launches,
           "kernel_vs_cpu_plain_max_abs": float(d.max()),
           "kernel_vs_cpu_plain_p99_abs": float(torch.quantile(
               d.flatten().double(), 0.99)),
           "row_words_differ_from_float32": int((row != row32).sum()),
           "image_vs_float32_route_max_abs": float(
               (img - img32).abs().max())}
    print(f"fused float64 {w}x{h}: {json.dumps(out)}")
    if not (img.dtype == torch.float32 and launches == 2
            and out["kernel_vs_cpu_plain_p99_abs"] < 1e-4
            and out["row_words_differ_from_float32"] > 0
            and bool(torch.equal(img, k.permute(1, 2, 0)))):
        raise AssertionError(f"fused float64: {out}")
    return out


def md_ad_scene():
    """(e)'s scene: the staged flagship physics at F64_MD_SIZE with the
    whole frame bloomed (F64_MD_POST)."""
    scene = flagship_scene(*F64_MD_SIZE, cfg=AD_CFG)
    return dataclasses.replace(scene, post=dataclasses.replace(
        scene.post, **F64_MD_POST))


def md_ad_grads(mesh, dtype):
    """The mean tone-mapped sharded image's gradient in the scene's seven
    leaves (float64 tensors), and the image."""
    sc, leaves = leaf_scene(md_ad_scene(), torch.float64)
    img = render_sharded(sc, mesh, dtype=dtype)
    grads = torch.autograd.grad(img.mean(), leaves)
    return [float(g) for g in grads], img.detach()


def _md_ad_worker(rank, world, directory, device):
    """One rank of (e)'s spawned gloo worlds: the sharded render's
    gradients in float32 and float64, to ``directory``."""
    global DEV
    DEV = device
    torch.cuda.set_device(torch.device(device).index or 0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{directory}/init", rank=rank,
        world_size=world)
    try:
        mesh = make_mesh(device=device)
        out = {}
        for dtype in (torch.float32, torch.float64):
            grads, img = md_ad_grads(mesh, dtype)
            out[str(dtype)] = grads
            torch.save(img.cpu(), os.path.join(directory,
                                               f"img_{rank}_{dtype}.pt"))
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


def f64_sharded_autograd():
    """(e) the sharded render under autograd, worlds 1 (NCCL in this
    process) and 2 and 3 (spawned gloo processes on the one card), float32
    and float64: every rank's leaf gradients identical and within
    F64_MD_REL of the single-device twin's; the forward image bit-equal to
    the single-device ``render`` of the twin (world 1) and the same on
    every rank."""
    import torch.multiprocessing as mp

    out = {}
    twin = {}
    twin_img = {}
    for dtype in (torch.float32, torch.float64):
        sc, leaves = leaf_scene(single_device_twin(md_ad_scene()),
                                torch.float64)
        img = render(sc, device=DEV, dtype=dtype)
        twin[dtype] = [float(g) for g in torch.autograd.grad(img.mean(),
                                                             leaves)]
        twin_img[dtype] = img.detach().cpu()
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group(
            MD_BACKEND, init_method=f"file://{tmp}/init1", rank=0,
            world_size=1)
        try:
            mesh = make_mesh(device=DEV)
            ranks = {1: [{}]}
            for dtype in (torch.float32, torch.float64):
                t0 = time.perf_counter()
                grads, img = md_ad_grads(mesh, dtype)
                torch.cuda.synchronize()
                ranks[1][0][str(dtype)] = grads
                ranks[1][0][f"{dtype} seconds"] = time.perf_counter() - t0
                if not torch.equal(img.cpu(), twin_img[dtype]):
                    raise AssertionError(f"sharded AD world 1 {dtype}: the "
                                         "image differs from the twin's")
        finally:
            torch.distributed.destroy_process_group()
        dirs = {n: os.path.join(tmp, f"w{n}") for n in (2, 3)}
        for d in dirs.values():
            os.makedirs(d)
        t0 = time.perf_counter()
        ctxs = [mp.start_processes(_md_ad_worker, args=(n, d, DEV), nprocs=n,
                                   join=False, start_method="spawn")
                for n, d in dirs.items()]
        deadline = time.monotonic() + MD_TIMEOUT
        for ctx in ctxs:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    for c in ctxs:
                        for proc in c.processes:
                            proc.kill()
                    raise AssertionError("phase 23's worlds outlived "
                                         f"{MD_TIMEOUT} s")
        out["spawned_seconds"] = time.perf_counter() - t0
        for n, d in dirs.items():
            ranks[n] = []
            for r in range(n):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    ranks[n].append(json.load(f))
                for dtype in (torch.float32, torch.float64):
                    im = torch.load(os.path.join(d, f"img_{r}_{dtype}.pt"))
                    ref = twin_img[dtype]
                    # row-major shards of one frame: the image is the same
                    # as world 1's up to the shards' own rays, which are
                    # the same rays; hold it equal
                    if not torch.equal(im, ref):
                        raise AssertionError(
                            f"sharded AD world {n} rank {r} {dtype}: the "
                            "image differs from the twin's")
    for dtype in (torch.float32, torch.float64):
        key, bar = str(dtype), F64_MD_REL[dtype]
        res = {"twin": twin[dtype]}
        for n, rk in ranks.items():
            gs = [x[key] for x in rk]
            same = all(g == gs[0] for g in gs)
            rel = max(_rel(g, t) for g, t in zip(gs[0], twin[dtype]))
            res[f"world{n}"] = {"identical_on_every_rank": same,
                                "max_rel_vs_twin": rel, "grads": gs[0]}
            if not (same and rel < bar
                    and all(math.isfinite(g) for g in gs[0])):
                raise AssertionError(f"sharded AD world {n} {dtype}: {res}")
        out[key] = res
    out["world1_seconds"] = {k: v for k, v in ranks[1][0].items()
                             if k.endswith("seconds")}
    print(f"sharded autograd {F64_MD_SIZE[0]}x{F64_MD_SIZE[1]}: "
          f"{json.dumps(out)}")
    return out


def phase_float64():
    """Phase 23: the float64 render (see the module docstring)."""
    t0 = time.perf_counter()
    out, entries = {}, []
    regs = {e: (r, sp) for e, r, sp in kbuild.ptxas_usage("march.cu")
            + kbuild.ptxas_usage("march_grad.cu") if "f64" in e}
    out["registers_spill"] = {sass_census.label(e): list(v)
                              for e, v in regs.items()}
    print(f"float64 instantiations' registers/spill: "
          f"{json.dumps(out['registers_spill'])}; gradient kernel "
          f"{grad_kernel_shape(False, False, F64)}")
    # (c) the 1080p float64 AD frames, with (a) and (b) on their own
    # recorded arguments
    for name, feats in (("flagship", Features(spectral_lut=True)),
                        ("jets", Features(spectral_lut=True, jets=True))):
        scene = flagship_scene(1920, 1080, cfg=F64_CFG, features=feats)
        info, m_args, g_args = ad_frames(scene, F64)
        jets = feats.jets
        if (m_args[0].dtype != F64 or (g_args[14] is not None) != jets
                or g_args[6].approx_recip):
            raise AssertionError(f"float64 {name}: the AD frame took the "
                                 "wrong instantiation")
        cmp, me = march_f64_entry(
            f"float64 AD {name} render_radiance 1920x1080", AD_FRAMES,
            m_args, "jets" if jets else "midpoint",
            "f64ILi2E" if jets else "f64ILi0E")
        with torch.no_grad():
            steps = march_u(*m_args)[2]
        info["march_vs_plain"] = cmp
        parent_gate(f"float64 AD {name} march", me["ms"])
        if jets:
            gargs, gouts = jets_crop_args(F64)
            ms_1080 = kernel_time(lambda: march_grad_kernel(*g_args), 3)[0]
            b_1080, by_1080 = grad_f64_bound(g_args, steps, True)
            gs, ge = grad_f64_entry(
                "float64 jets gradient, 64x64 crop of the 1080p jets scene",
                AD_FRAMES, gargs, gouts[2], True, ms_1080p=ms_1080,
                bound_ms_1080p=b_1080, bound_by_1080p=by_1080,
                share_of_bound_1080p=b_1080 / ms_1080,
                lane_efficiency_1080p=grad_census.lane_efficiency(
                    LANE_COUNT_LIB, g_args),
                lane_efficiency_one_per_thread_1080p=(
                    grad_census.block_lane_efficiency(steps, CKPT_F64)))
            parent_gate("float64 AD jets gradient", ms_1080)
        else:
            gs, ge = grad_f64_entry(
                f"float64 AD {name} render_radiance 1920x1080", AD_FRAMES,
                g_args, steps, False)
            parent_gate("float64 AD flagship gradient", ge["ms"])
        info["grad_vs_plain"] = gs
        print(f"float64 AD {name} render_radiance 1920x1080: forward + "
              f"backward {info['fwd_bwd_ms']:.1f} ms (median of "
              f"{AD_FRAMES}), forward {info['fwd_ms']:.1f} ms; march "
              f"{me['ms']:.3f} ms (bound {me['bound_ms']:.3f}), gradient "
              f"{ge['ms']:.3f} ms; march vs plain {cmp}; gradient vs plain "
              f"{gs}; gradients {info['grads']}")
        out[name] = info
        entries += [me, ge]
    out["gates"] = ad_gates(dtype=F64)
    # (a) AB3 and (a) + (b) on KMAX 8
    out["march"] = f64_march_variants(entries)
    out["k8"] = f64_k8(entries)
    # (b) on phase 7's recorded inputs
    out["phase7_grad"] = f64_phase7_grad()
    # (d) fused
    out["fused"] = f64_fused()
    # (e) the sharded render under autograd
    out["sharded_autograd"] = f64_sharded_autograd()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 23 (float64 render): {out['seconds']:.1f} s")
    return out, entries


# Phase 24: the composite kernels against the plain composite on the card.
COMPOSITE_VJP_BAR = 1e-5
BIRTH_VJP_BAR = 1e-5
# The arithmetic ATen ops that ``composite_ops`` counts, each output value
# one operation (copies, casts to other shapes and allocations are not).
_COUNTED_OPS = {
    "add", "sub", "mul", "div", "neg", "reciprocal", "sqrt", "exp", "log",
    "pow", "sin", "cos", "floor", "remainder", "abs", "sign", "maximum",
    "minimum", "clamp", "where", "lt", "gt", "le", "ge", "eq", "ne",
    "bitwise_and", "logical_and", "_to_copy"}


def _count_ops(fn) -> int:
    """The output values of the counted ATen ops that ``fn()`` runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__.rstrip("_") in _COUNTED_OPS:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                Count.n += sum(o.numel() for o in outs
                               if isinstance(o, torch.Tensor))
            return out

    with Count():
        fn()
    return Count.n


def composite_ops(c, x):
    """(operations a ray of each kind needs, forward total, VJP total),
    counted on the plain twin's arithmetic on one ray (``ops/composite.py``,
    the kernels' line for line) and summed over the rays ``x`` holds. The
    forward shades each filled crossing (3 octaves the first, 1 the
    others) and, for each escaped ray, the escape direction, the starfield
    and the glow. The VJP shades the filled crossings again, then each
    compositing (filled and valid) crossing along 9 directions, and for each
    escaped ray the escape direction, the starfield along 3 directions, the
    escape direction along 9 and the glow along 2."""
    from blackhole_simulation_tpu_torch.ops import composite as comp

    cpu = lambda t: t.detach().to("cpu")
    one = lambda t: cpu(t).reshape(-1)[:1]
    m, a, r_in, r_ph = (cpu(x[k]) for k in ("m", "a", "r_in", "r_ph"))
    ds, is_ = cpu(x["ds"]), cpu(x["is"])
    r, phi, t, lam = (one(x[k]) for k in ("cross_r", "cross_phi", "cross_t",
                                          "lam"))
    rmin = one(x["r_min_ph"])
    srows = tuple(cpu(x["state_u"])[i, :1] for i in range(1, 8))
    seed = comp._seed
    yes = torch.ones(1, dtype=torch.bool)
    per = {}
    for octaves in (3, 1):
        per[f"slot{octaves}"] = _count_ops(lambda: comp._slot(
            c, m, a, r_in, r, phi, t, lam, octaves, c.disk.density * ds,
            is_))
        per[f"slot{octaves}_d9"] = _count_ops(lambda: comp._slot(
            c, seed(m, 4, 9), seed(a, 5, 9), seed(r_in, 6, 9),
            seed(r, 0, 9), seed(phi, 1, 9), seed(t, 2, 9), seed(lam, 3, 9),
            octaves, c.disk.density * seed(ds, 7, 9), seed(is_, 8, 9)))
    dirs = comp._escape_direction_u(srows, m, a)
    per["escape"] = _count_ops(lambda: comp._escape_direction_u(srows, m, a))
    per["escape_d9"] = _count_ops(lambda: comp._escape_direction_u(
        tuple(seed(v, i, 9) for i, v in enumerate(srows)), seed(m, 7, 9),
        seed(a, 8, 9)))
    per["starfield"] = _count_ops(lambda: comp._starfield(*dirs, c))
    per["starfield_d3"] = _count_ops(lambda: comp._starfield(
        *(seed(v.v, i, 3) for i, v in enumerate(dirs)), c))
    per["glow"] = _count_ops(lambda: comp._glow(rmin, r_ph, yes))
    per["glow_d2"] = _count_ops(lambda: comp._glow(
        seed(rmin, 0, 2), seed(r_ph, 1, 2), yes))
    k = x["cross_r"].shape[0]
    nc = torch.clamp(x["n_crossings"].long(), 0, k)
    filled = torch.arange(k, device=nc.device)[:, None] < nc[None, :]
    cr = x["cross_r"]
    valid = filled & (cr > x["r_in"]) & (cr < c.disk.outer_radius)
    escaped = int((x["hit"] == 2).sum())
    first, rest = int(filled[0].sum()), int(filled[1:].sum())
    on_first, on_rest = int(valid[0].sum()), int(valid[1:].sum())
    slots = first * per["slot3"] + rest * per["slot1"]
    fwd = slots + escaped * (per["escape"] + per["starfield"] + per["glow"])
    vjp = (slots + on_first * per["slot3_d9"] + on_rest * per["slot1_d9"]
           + escaped * (per["escape"] + per["starfield_d3"]
                        + per["escape_d9"] + per["glow_d2"]))
    return per, fwd, vjp


def _recorded_composite(step, state, target):
    """The composite's inputs of one call of ``step``, as the kernel path
    gets them, detached."""
    from blackhole_simulation_tpu_torch.ops import composite as comp

    got, orig = [], comp.composite_rows

    def record(*args):
        got.append(args)
        return orig(*args)

    comp.composite_rows = record
    try:
        step(state, target)
    finally:
        comp.composite_rows = orig
    d = lambda v: v.detach() if isinstance(v, torch.Tensor) else v
    return tuple(d(v) for v in got[0])


def phase_composite():
    """Phase 24 (module docstring)."""
    from benchmark.drivers.fits import port_scene
    from blackhole_simulation_tpu_torch.geometry import metrics
    from blackhole_simulation_tpu_torch.ops import composite as comp
    from blackhole_simulation_tpu_torch.parallel.train import (
        init_opt_state,
        make_ad_inverse_step,
    )
    from blackhole_simulation_tpu_torch.render.pipeline import (
        _DUMMY_U,
        _composite,
    )

    t0 = time.perf_counter()
    config = json.loads(Path("benchmark/configs/inverse_1080p.json")
                        .read_text())
    scene = port_scene(config, DEV)
    target = render_radiance(scene, device=DEV)
    step = make_ad_inverse_step(scene, None, 3e-2, pool=8, march_steps=64,
                                clip=0.03, total_steps=20, device=DEV)
    init = InverseParams.init(**config["init"], device=DEV)
    state = (init, init_opt_state(init))
    step(state, target)
    (c, m, a, hit, cr, cphi, ct, nc, rmin, lam, st, jets, ds,
     is_) = _recorded_composite(step, state, target)
    torch.cuda.synchronize()
    r_in, r_ph = metrics.isco_t(m, a), metrics.photon_sphere_t(m, a)
    x = dict(m=m, a=a, r_in=r_in, r_ph=r_ph, hit=hit, cross_r=cr,
             cross_phi=cphi, cross_t=ct, n_crossings=nc, r_min_ph=rmin,
             lam=lam, state_u=st, jet_rows=jets, ds=ds, **{"is": is_})
    n, k = lam.shape[0], cr.shape[0]
    args = (c, m, a, r_in, r_ph, hit, cr, cphi, ct, nc, rmin, lam, st, jets)
    fwd_ms, out = kernel_time(
        lambda: comp.composite_kernel(*args, ds, is_), 20)
    g = torch.rand((3, n), device=DEV, generator=torch.Generator(
        DEV).manual_seed(24)) * 2.0 - 1.0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vjp_ms, grads = kernel_time(
        lambda: comp.composite_vjp_kernel(*args, g, ds, is_), 20)
    kernel_peak = torch.cuda.max_memory_allocated() - base
    again = comp.composite_vjp_kernel(*args, g, ds, is_)
    reproducible = all(torch.equal(v, again[key]) for key, v in grads.items())

    def plain(leaves=None):
        y = {**x, **(leaves or {})}
        saved = metrics.isco_t, metrics.photon_sphere_t
        metrics.isco_t = lambda m_, a_: y["r_in"]
        metrics.photon_sphere_t = lambda m_, a_: y["r_ph"]
        try:
            return _composite(scene, y["m"], y["a"], hit,
                              (y["cross_r"], y["cross_phi"], y["cross_t"]),
                              nc, y["r_min_ph"], y["lam"], y["state_u"],
                              escape_direction_u_rows, _DUMMY_U,
                              y["jet_rows"], y["ds"], y["is"],
                              scene.spectral_coeffs, None)
        finally:
            metrics.isco_t, metrics.photon_sphere_t = saved

    with torch.no_grad():
        want = torch.stack(plain())
        plain_fwd_ms = timed(plain, 3)[0]
    differ = int((~((out == want) | (out.isnan() & want.isnan()))).sum())
    names = ("cross_r", "cross_phi", "cross_t", "state_u", "r_min_ph", "lam",
             "a", "r_in", "r_ph", "ds", "is")

    def plain_fwd_bwd():
        leaves = {key: x[key].clone().requires_grad_(True) for key in names}
        rgb = plain(leaves)
        return torch.autograd.grad(
            sum((o * gg).sum() for o, gg in zip(rgb, g)),
            [leaves[key] for key in names], allow_unused=True)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plain_fb_ms = timed(plain_fwd_bwd, 3)[0]
    plain_peak = torch.cuda.max_memory_allocated() - base
    twin = comp.composite_vjp_plain(*args, g, ds, is_)
    rel = {}
    for key in (*names, "m"):
        w = twin[key]
        dd = (grads[key] - w).abs()
        if w.dim() == 2:
            rel[key] = float((dd.amax(-1) / w.abs().amax(-1).clamp(
                min=1e-30)).max())
        else:
            rel[key] = float(dd.max() / w.abs().max().clamp(min=1e-30))
    per, fwd_ops, vjp_ops = composite_ops(c, x)
    escaped = int((hit == 2).sum())
    filled = int(torch.clamp(nc.long(), 0, k).sum())
    # bytes the rays need: hit, n_crossings, lam, each filled crossing's
    # three values, an escaped ray's seven state values and r_min_ph, the
    # scalars; out: (3, N)
    fwd_bytes = 4 * (3 * n + 3 * filled + 8 * escaped) + 4 * 3 * n
    vjp_bytes = (fwd_bytes + 4 * 3 * n          # the cotangent in
                 + 4 * (3 * k * n + 8 * n + 2 * n))   # the rows' out
    fwd_bound, fwd_by = bound(fwd_ops, fwd_bytes)
    vjp_bound, vjp_by = bound(vjp_ops, vjp_bytes)
    variant = comp.variant(c, lam.dtype)
    usage = kbuild.ptxas_usage("composite.cu", kbuild.kmax_for(k), variant)
    info = {
        "rays": n, "slots": k, "filled_crossings": filled,
        "escaped": escaped, "forward_ms": fwd_ms, "vjp_ms": vjp_ms,
        "forward_bound_ms": fwd_bound, "forward_bound_by": fwd_by,
        "vjp_bound_ms": vjp_bound, "vjp_bound_by": vjp_by,
        "forward_ops": fwd_ops, "vjp_ops": vjp_ops, "ops_per_ray_kind": per,
        "forward_bytes": fwd_bytes, "vjp_bytes": vjp_bytes,
        "plain_forward_ms": plain_fwd_ms,
        "plain_forward_backward_ms": plain_fb_ms,
        "kernel_vjp_peak_bytes": kernel_peak,
        "plain_autograd_peak_bytes": plain_peak,
        "forward_values_differing": differ, "vjp_rel_vs_plain": rel,
        "vjp_reproducible": reproducible,
        "registers_spill": {e: [r_, s_] for e, r_, s_ in usage},
        "variant": list(variant),
    }
    info["seconds"] = time.perf_counter() - t0
    print(f"phase 24 (composite): {json.dumps(info)}")
    if differ or not reproducible or max(rel.values()) > COMPOSITE_VJP_BAR:
        raise AssertionError(f"composite kernels against the plain: {info}")
    return info


def phase_inverse_fit():
    """Phase 25 (module docstring): every step of one fit against the
    reference."""
    import types

    from benchmark.drivers import fits as fits_driver
    from blackhole_simulation_tpu_torch.parallel.train import init_opt_state

    class KeepAll(fits_driver.Fits):
        """A fit that keeps every step for the check."""

        def fit(self, keep: bool):
            params, losses = self.init(), []
            for s, fn in enumerate(self.steps):
                state = (params, init_opt_state(params))
                for _ in range(self.per):
                    entering = state
                    state, loss = self._step(fn, state)
                    losses.append(float(loss))
                    p, (m_, v_, t_) = entering
                    self.kept.append(fits_driver.Kept(
                        s, int(t_), fits_driver._values(p),
                        fits_driver._values(m_), fits_driver._values(v_),
                        losses[-1], fits_driver._values(state[0]),
                        fits_driver._values(state[1][0])))
                params = state[0]
            return losses, params

    t0 = time.perf_counter()
    read = lambda f: json.loads(Path(f).read_text())
    spec = types.SimpleNamespace(
        config=read("benchmark/configs/inverse_1080p.json"),
        traffic=read("benchmark/traffic/ad_curriculum.json"),
        device=torch.device(DEV), seed=0)
    limits = read("benchmark/limits/inverse_1080p.ad_curriculum.json")
    fits = KeepAll(spec)
    fits.setup()
    fits.kept = []
    losses, _ = fits.fit(keep=True)
    fits.release()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    steps = []
    for kept in fits.kept:
        ref = fits.reference(kept)
        steps.append(fits.numbers([(fits.port_result(kept),
                                    fits.ref_result(ref, kept))]))
        torch.cuda.empty_cache()
    largest = {key: max(s_[key] for s_ in steps) for key in steps[0]}
    out = {"steps": steps, "largest": largest,
           "limits": {key: limits[key] for key in largest},
           "losses": losses, "seconds": time.perf_counter() - t0}
    print(f"phase 25 (inverse fit): {json.dumps(out)}")
    if any(largest[key] >= limits[key] for key in largest):
        raise AssertionError(f"a step of the fit past a limit: {largest}")
    return out


def _recorded_ray_cotangent(step, state, target):
    """The cotangent of the rays that one call of ``step`` gives its
    birth."""
    from blackhole_simulation_tpu_torch.render import camera

    got, orig = [], camera.camera_rays_u

    def record(*args, **kw):
        rays = orig(*args, **kw)
        rays.register_hook(got.append)
        return rays

    camera.camera_rays_u = record
    try:
        step(state, target)
    finally:
        camera.camera_rays_u = orig
    return got[0]


def phase_birth():
    """Phase 26 (module docstring)."""
    from benchmark.drivers.fits import port_scene
    from blackhole_simulation_tpu_torch.ops import birth as bk
    from blackhole_simulation_tpu_torch.parallel.train import (
        init_opt_state,
        make_ad_inverse_step,
    )
    from blackhole_simulation_tpu_torch.render.camera import (
        camera_rays_u_plain,
    )

    t0 = time.perf_counter()
    config = json.loads(Path("benchmark/configs/inverse_1080p.json")
                        .read_text())
    scene = port_scene(config, DEV)
    cam = scene.camera
    target = render_radiance(scene, device=DEV)
    init = InverseParams.init(**config["init"], device=DEV)
    step = make_ad_inverse_step(scene, None, 3e-2, pool=8, march_steps=64,
                                clip=0.03, total_steps=20, device=DEV)
    state = (init, init_opt_state(init))
    step(state, target)
    g_step = _recorded_ray_cotangent(step, state, target)
    m = torch.tensor(1.0, device=DEV)
    ids = torch.arange(cam.width * cam.height, device=DEV)
    a, th = init.spin, init.theta_cam
    plan, inputs = bk.plan_of(cam, m, a, ids, None, th)
    n = plan.n
    fwd_ms, out = kernel_time(lambda: bk.birth_kernel(plan, inputs), 20)
    plain = lambda *xs, dtype=torch.float32: camera_rays_u_plain(
        cam, xs[0], xs[1], pix_ids=ids, theta=xs[2], dtype=dtype)
    with torch.no_grad():
        want = plain(m, a, th)
        plain_fwd_ms = timed(lambda: plain(m, a, th), 5)[0]
    differ = int((~((out == want) | (out.isnan() & want.isnan()))).sum())
    g_uniform = torch.rand((8, n), device=DEV, generator=torch.Generator(
        DEV).manual_seed(26)) * 2.0 - 1.0
    wanted = (True, True, True) + (False,) * 5
    vjp_ms, grads = kernel_time(
        lambda: bk.birth_vjp_kernel(plan, inputs, g_step, wanted), 20)
    again = bk.birth_vjp_kernel(plan, inputs, g_step, wanted)
    reproducible = all(torch.equal(x, y) for x, y in zip(grads[:3],
                                                         again[:3]))

    def auto(g, dtype):
        leaves = [x.detach().to(dtype).requires_grad_(True)
                  for x in (m, a, th)]
        rows = plain(*leaves, dtype=dtype)
        return torch.autograd.grad((rows * g.to(dtype)).sum(), leaves)

    plain_fb_ms = timed(lambda: auto(g_step, torch.float32), 3)[0]
    rel = {}
    for name, g in (("step", g_step), ("uniform", g_uniform)):
        kernel = bk.birth_vjp_kernel(plan, inputs, g, wanted)[:3]
        twin = bk.birth_vjp_plain(plan, inputs, g)
        twin = [twin[k] for k in ("m", "a", "theta")]
        a32, a64 = auto(g, torch.float32), auto(g, torch.float64)
        r = lambda x, y: [float(abs(float(u) - float(v)) / abs(float(v)))
                          for u, v in zip(x, y)]
        rel[name] = {"kernel_vs_autograd32": r(kernel, a32),
                     "kernel_vs_autograd64": r(kernel, a64),
                     "autograd32_vs_autograd64": r(a32, a64),
                     "kernel_vs_twin": r(kernel, twin),
                     "kernel": [float(x) for x in kernel],
                     "autograd32": [float(x) for x in a32]}
    fwd_bytes = n * (8 + 8 * 4)
    vjp_bytes = n * (8 + 6 * 4)
    # the operations a ray: ~40 forward, ~110 in the VJP (its forward
    # again and the sweep): far below the bytes' bound either way
    fwd_bound, fwd_by = bound(40 * n, fwd_bytes)
    vjp_bound, vjp_by = bound(150 * n, vjp_bytes)
    info = {
        "rays": n, "forward_ms": fwd_ms, "vjp_ms": vjp_ms,
        "forward_bound_ms": fwd_bound, "forward_bound_by": fwd_by,
        "vjp_bound_ms": vjp_bound, "vjp_bound_by": vjp_by,
        "plain_forward_ms": plain_fwd_ms,
        "plain_forward_backward_ms": plain_fb_ms,
        "forward_values_differing": differ, "vjp_rel": rel,
        "vjp_reproducible": reproducible,
        "registers_spill": {e: [r_, s_] for e, r_, s_ in
                            kbuild.ptxas_usage("birth.cu")},
        "seconds": time.perf_counter() - t0,
    }
    print(f"phase 26 (birth): {json.dumps(info)}")
    if differ or not reproducible or max(
            rel["step"]["kernel_vs_autograd32"]) > BIRTH_VJP_BAR:
        raise AssertionError(f"birth kernels against the plain: {info}")
    return info


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    t_start = time.perf_counter()
    only = sys.argv[1:]
    if only:
        named = {"composite": phase_composite,
                 "inverse_fit": phase_inverse_fit, "birth": phase_birth}
        for name in only:
            named[name]()
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s total")
        return 0
    phase_build()
    peak = phase_peak()
    phase_short_parity()
    print(f"approx route: {json.dumps(phase_flagship_parity())}")
    kernel, tonemap_line = phase_main_path()
    phase_march_parity()
    phase_grad_parity()
    train, kernels = phase_train()
    print(f"training: {json.dumps(train)}")
    ab3, ab3_kernels = phase_ab3(kernel)
    print(f"AB3: {json.dumps(ab3)}")
    certified, certified_kernels = phase_certified()
    print(f"certified: {json.dumps(certified)}")
    features = phase_features_parity()
    full, full_kernels = phase_full_featured(kernel)
    print(f"features: {json.dumps({'parity': features, **full})}")
    edges = phase_edges()
    print(f"edges: {json.dumps(edges)}")
    kernels_line = [kernel, tonemap_line, *kernels, *certified_kernels,
                    *ab3_kernels, *full_kernels, peak]
    probes = phase_probes(kernels_line)
    print(f"probes: {json.dumps(probes)}")
    phase_census(kernels_line)
    print(f"oracle: {json.dumps(phase_oracle_gates())}")
    print(f"fd: {json.dumps(phase_fd())}")
    nrs, nrs_kernels = phase_nrs(full["full-featured"]["ms"])
    print(f"nrs: {json.dumps(nrs)}")
    tiles, tile_kernels = phase_tiles()
    print(f"tiles: {json.dumps(tiles)}")
    print(f"taa: {json.dumps(phase_taa())}")
    print(f"engine: {json.dumps(phase_engine())}")
    app, live_kernel = phase_app()
    print(f"app: {json.dumps(app)}")
    multi, md_kernels = phase_multi_device()
    print(f"multi-device: {json.dumps(multi)}")
    ad, ad_kernels = phase_ad_render()
    print(f"differentiable render: {json.dumps(ad)}")
    f64, f64_kernels = phase_float64()
    print(f"float64 render: {json.dumps(f64)}")
    phase_composite()
    phase_inverse_fit()
    phase_birth()
    for e in nrs_kernels + tile_kernels + [live_kernel]:
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
    kernels_line += (nrs_kernels + tile_kernels + [live_kernel] + md_kernels
                     + ad_kernels + f64_kernels)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s total")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
