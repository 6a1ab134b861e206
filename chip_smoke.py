#!/usr/bin/env python3
"""Drive the PyTorch port's geoVI main path once on one NVIDIA card:
Gaussian, Poisson-count, Bernoulli and density-estimation maps on
correlated fields, iterative charted refinement (ICR) fields on a
deformed chart, the HEALPix sphere and sphere x radius, spherical
correlated fields on HEALPix and Gauss-Legendre grids, line-of-sight
tomography of 3-D fields with a NUTS cross-check, radio interferometry
(a w-stacked NUFFT response), and the inference and diagnostics around
them: the Wiener filter, parametric VI, the evidence lower bound and the
first-order and trust-region minimizers, the INI-file driver (demo 7 and
a config-file twin of phase 9) and the instrumentation at 4096^2; then
the same port on several
ranks: the pencil transforms, demo 4, phase 6's update field- and
sample-sharded, and the sharded checkpoint, in a gloo world of four ranks
on one card and an NCCL world over every card (it starts both), where
phase 27's 256^3 tomography runs field- and sample-sharded and phase
19's 4100^2 ICR chart sample-sharded.

    python3 chip_smoke.py

Phases (one line each, with its seconds):

1. require a CUDA device and print ``nvidia-smi``'s name and power limit,
   then whether the optional host libraries import (``h5py: present`` or
   ``h5py: absent``, the same for matplotlib): where one is absent the
   HDF5 export or the figures are not run, where it is present an
   exception from it fails the run;
2. build the distributor kernels, the refinement kernels, the HEALPix
   longitude kernels, the ray integral kernels and the NUFFT window
   kernels (``nvcc``, one compiler a source, all started together) and the
   HEALPix core (the host's C++ compiler);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes in float64 and float32 (gather bit-exact; segment sum within
   1e-12 / 1e-5 of the per-bin sum of |cot|, bitwise reproducible, and
   bitwise equal when replayed from a CUDA graph), at every number of
   table rows the main path gives a map (1, 2, 4 and 8 at 128^2), plus two
   rows of the odd-length 4096^2 quarter map (rows start misaligned), and
   time both:
   host-paced ms per call (CUDA events around 50 back-to-back calls,
   kernel and plain in turns; 10 for a map of a million entries a call or
   more) and device ms per call (the same calls captured in a CUDA graph
   and replayed).  Each map's line names the
   segment sum's work: its items, the short bins among them by class (4, 8
   or 32 lanes a bin), the split bins (chunks plus a second pass) and the
   chunk size C; the segment sum must also equal, bit for bit, the same
   sum with every short bin given a whole warp;
   the unbinned quarter maps of 1024^2 (82,799 modes: int32 index, a table
   above the 227 KB a block can hold, short bins only; at 8 rows the gather
   goes through a rows-innermost copy of the table) and of 4096^2
   (1,197,363 modes, a 9.6 MB table a float64 row, every class of short
   bins and 9 block items) are among the shapes, as are the 1-D subgrid
   maps of 16 and 64 entries (9 and 33 bins, uint8 index) at 1, 4, 8, 12
   and 24 rows, the 512^2 unbinned full-grid map (22,026 bins, int16
   index), the 256-entry 1-D map of ``density_estimator(128, 1/128)``
   (129 bins, uint8 index) at 1, 2 and 4 rows, and the l map of a
   spherical field at lmax 511 (262,144 modes in 512 bins, int16 index: 16
   short bins, the rest block items) at 1, 2, 4 and 8 rows, and the
   tomography fields' maps: the 16^3 and 64^3 unbinned full-grid maps at 1,
   4 and 8 rows and the 129^3 quarter map of 256^3 with ``n_bins=128``
   (2,146,689 entries) at 1 and 2, and demo 11's 64^2 full-grid map at 1,
   2 and 4; and the mesh phases' maps: a field rank's rows of the
   full-grid maps of phase 6's 4096^2, demo 4's and phase 27's 256^3
   field, the whole maps, and their (row, bin) maps;
4. one 32^2 update on the CPU (plain versions) and on the card (kernels)
   from the same latents and host-drawn noise, once with the sample loop
   (``residual_map="smap"``) and once with the lockstep batched solvers
   (``"vmap"``): final KL energies agree to 1e-8 relative for both; the
   same for a two-subgrid field with ``total_N=3, dofdex=[0, 0, 1]`` (a
   32^2 non-parametric subgrid times an 8-channel Matern subgrid), for
   Poisson counts on the exp of a 32^2 field (``Poissonian``) and for a
   ``LikelihoodSum`` of those counts and a ``Gaussian`` on a second 32^2
   field (a dict domain of both fields' latents), for two ICR fields: a
   deformed 2-D chart (20^2) and sphere x radius (192 x 8), and for two
   spherical fields (demo 16's priors): Gauss-Legendre at lmax 16 and
   HEALPix at lmax 15, nside 8, for a 16^3 tomography (32 rays x 32
   points, K11 on the card), for radio imaging of the exp of a 32^2 field
   (phase 35's model with 4000 visibilities in 8 w-planes, a complex
   ``Gaussian``; K7 on the card), and for the first case with its KL stage
   minimized by ``trust_ncg`` (subproblems of 5 steps) and by ``lbfgs``
   (both 3 iterations); on the first case's 32^2 field, the Wiener
   filter of its data (demo 5's prior, a 70 % mask, 20 CG steps
   preconditioned by S) with the posterior means within 1e-8 relative, and
   the SLQ evidence (``HostKey`` probes, 8 in lockstep, 30 steps) of the
   CPU's posterior after one update, the same samples on both devices,
   with ``elbo_mean`` within 1e-8 relative;
5. the 128^2 unbinned config (``bench.py``'s headline, ``residual_map=
   "vmap"``: the residual stages run the lockstep batched solvers and the
   KL stage stacks the 8 samples): three updates;
6. the 4096^2 ``n_bins=128`` config with the sample loop (``smap``) for
   both stages: one update;
7. the adaptive 128^2 config (``bench.py``'s ``bench_adaptive``:
   ``absdelta`` controllers, ``napprox=8``, CG budgets 200/60/100,
   ``residual_map="vmap"``): three updates, and its KL energy within 2 %
   of phase 5's after the same number of updates;
8. the 1024^2 unbinned config (no ``n_bins``; ``residual_map="smap"``,
   ``kl_map="auto"``): one update, twice, with bitwise equal KL energies;
9. the whole loop: ``optimize_kl`` as ``demos/0_intro.py`` calls it (the
   exp-of-field signal at 128^2, schedules by iteration, ``odir`` in a
   temporary directory), three iterations, then a fourth once resumed from
   the checkpoint (``resume=True``) and once continued in memory: the two
   fourth iterations must be bitwise equal; ``odir`` must hold the
   checkpoint, the report and (where matplotlib imports) the energy
   history's figure; the demo's ``Plot`` summary is drawn (phases 11, 13
   and 31 draw their demos' figures too, each file's size printed);
10. the 4096^2 unbinned config (1,197,363 modes; the sample loop for both
    stages): one update;
11. ``optimize_kl`` as ``demos/10_multifrequency.py`` calls it: 64 pixels
    times 16 frequency channels, noise 0.2, data from the prior, five
    iterations; the posterior mean's rms error against the truth must be
    below the noise level;
12. space times frequency at grid scale: the demo's two subgrids and
    priors with a 512^2 spatial subgrid (unbinned, 22,026 bins on the
    full-grid map) times 64 channels (33 bins), 16.8 M field entries, the
    sample loop for both stages: one update, with both kernels launched on
    both subgrids' maps;
13. ``optimize_kl`` as ``demos/2_poisson_counts.py`` calls it: Poisson
    counts (numpy, from the seed) of the exp of a 128^2 field with offset
    mean 2 drawn from the prior, 5 iterations of 4 pairs, draw CG 80, geoVI
    4 x ``xtol`` 1e-3, KL 20 x ``xtol`` 1e-4, lockstep (``"auto"``): the
    posterior mean of the rates must be closer (rms) to the true rates than
    the counts are; prints the minisanity table of the data residual;
14. ``demos/14_bernoulli_map.py``: one Bernoulli event a pixel on a sigmoid
    of a 128^2 field with IWP deviations, 12 MAP iterations (``n_samples=0``,
    KL 25 x CG 60), then 4 geoVI iterations at the demo's budgets: the
    posterior mean's mean |p - truth| below 0.25 and 2-sigma coverage above
    0.9, the demo's check;
15. Poisson counts at grid scale: the exp of phase 8's 1024^2 unbinned
    field, ``BENCH_KWARGS``, ``residual_map="smap"``, ``kl_map="auto"``: one
    update;
16. ``demos/6_density_estimation.py``: 1500 events from two modes in 128
    bins, the rate ``density_estimator(128, 1/128)`` (a Matern field on the
    padded 256-entry 1-D grid), 6 iterations of 2 pairs: predicted events
    within 25 % of those observed and the two modes found;
17. the ICR fields of phases 18-21 are built (host precompute, printed with
    its seconds), and the refinement step (K9) and its transpose are held
    against their plain versions at every (level, rows) shape those phases
    launch, in float64 and float32 (within 1e-12 / 1e-5 of the largest
    entry), bitwise reproducible and equal to a CUDA-graph replay, with
    float64 device ms beside the bound (and the share of it), the plain
    versions' ms, each level's routes, and each kernel's registers, spilled
    bytes and shared memory a block, and, for the 2-D levels of the 3 x 3 /
    2 x 2 stencil, the library's routes on an undeformed chart of the same
    shape (``conv2d`` + ``pixel_shuffle``; ``pixel_unshuffle`` +
    ``conv_transpose2d`` + ``conv2d``), held to the kernels on shared
    matrices;
18. ``demos/9_icr_refinement.py``: a log-deformed 1-D chart (14 pixels,
    depth 5, Matern-3/2), exp(0.5 gp) on a third of the pixels with noise
    0.05, ``optimize_kl`` with 6 iterations of 4 pairs: the truth within 3
    (std + noise) of the posterior mean on at least 90 % of the pixels;
19. a 4100^2 deformed chart ((20, 20), depth 8, demo 9's deformation on
    axis 0; 22.4 M latent dof), demo 9's model on a third of the pixels,
    ``BENCH_KWARGS``, the sample loop: one update;
20. a HEALPix sphere from nside 4 to 256 (786,432 pixels), Gaussian data:
    one update;
21. sphere x radius (a 3-D dust-map geometry): nside 2 to 64 times a
    log-spaced radial chart of 6 to 68 shells (3.34 M voxels): one update;
22. the HEALPix longitude stage (K10, ring FFTs) and its adjoint against
    their plain versions at every (nside, rows) shape phase 23 launches
    (nside 256, mmax 511), in float64 and float32 (within 1e-12 / 1e-5 of
    the per-output sum of |term|, a term's modulus taken as a complex
    number), bitwise reproducible and equal to a CUDA-graph replay, with
    float64 device ms beside the bound (the bytes, or the ring FFTs'
    operations where larger) and the share of it reached, the same ring FFT
    form in ``torch.fft`` (the library route), the plain versions' ms and
    the JAX formulation's with stored phase tables (the plain loop over
    64-m chunks of the ``(512, npix)`` cos and sin tables, built once for
    the phase), and each block's shared memory (2, 4 and 8 rows, which no
    phase launches, held in both types, the kernels and the ``torch.fft``
    route timed in float64); then nside 2048 at mmax
    511, one row (50,331,648 pixels; its 2046 polar rings of more than 4096
    pixels transform in the workspace), held to the same tolerances against
    the plain versions on 51 of its rings from pole to pole (the whole
    grid's phase chunks would not fit the card), repeated and replayed,
    timed beside the bound (the ``torch.fft`` route there, a cuFFT plan for
    each of 2048 ring lengths, was timed once, PERF.md, and is not rebuilt
    in every run);
23. ``demos/16_spherical_cf.py`` at its full width: the demo's HEALPix
    sky at lmax 511, nside 256 (786,432 pixels, 262,144 harmonic dof),
    observed directly as the demo does, with the demo's priors, noise 0.5
    on the pixels within 0.1 of the middle of the ring order (the
    equatorial band) and 0.1 elsewhere, data from the prior,
    ``optimize_kl`` with the demo's schedule (4 iterations of 4 pairs, the
    sample loop for both stages): the posterior mean's rms error below the
    truth's rms, the demo's check; fails unless K10, K10^T and both
    distributor kernels launched; prints the KL energy's change from the
    one it ended at with K10 summed directly;
24. a Gauss-Legendre sphere at grid scale: lmax 511 (512 x 1024 = 524,288
    pixels), ``bench.py``'s amplitude priors, noise 0.1, ``BENCH_KWARGS``,
    the sample loop: one update.
25. the ray integral of line-of-sight tomography (K11) and its adjoint
    against their plain versions at every (grid, rays, points, rows) shape
    phases 26-28 launch, in float64 and float32 (within 1e-12 / 1e-5 of the
    per-output sum of |term|), bitwise reproducible, equal to a CUDA-graph
    replay and, row by row, to one-row calls (the rows a block serves move
    no bits), with each kernel's registers and spills from the build's
    ``-Xptxas -v`` printed once and float64 device ms beside the bound (the tables,
    the touched cells' values or the cotangents, and the output, once
    each) and the share of it reached, the plain versions' and the library
    routes' ms (``torch.sparse.mm`` of the rays' CSR matrix; ``index_add_``);
    and the same for every table of the slabs phase 44 launches on (rows
    0-127 and 128-255 of the 256^3 grid, a field rank's of the 2 x 2
    world, and all 256 rows, the 1 x 1 world's; and rows 0-7 of a 16^3
    grid): each slab's own table (the adjoint's CSR by cell) and its
    virtual-ray tables, one a width (the (ray, row) pairs' entries padded
    to a power of two); then each slab's whole forward under
    ``deterministic_reductions`` (every virtual-ray table, the partials
    placed in (rows, rays)) and its adjoint against their plain versions
    (1e-12 / 1e-5 of the per-output sum of |term|, the forward bitwise
    reproducible), with float64 device ms beside the bound, the plain
    versions' ms and ``torch.sparse.mm`` of the virtual rays' CSR and of
    the slab table's transpose;
26. ``demos/1_tomography.py``'s ``main()`` as written: a 64^3 field, 128
    rays x 128 points, ``optimize_kl`` with 5 iterations of 4 pairs,
    ``linear_resample``, draw CG 60, KL 15 x ``xtol`` 1e-4: the mean
    reduced chi^2 of the normalized data residual in [0.5, 2] and the
    posterior mean of exp(cf) finite everywhere;
27. its ``main_at_scale()`` at full width: 256^3 (16.8 M dof) with
    ``n_bins=128``, 1024 rays x 256 points, 2 samples,
    ``nonlinear_resample`` at the demo's budgets from 0.1 times a prior
    draw, the sample loop, 3 iterations, each printed with its seconds,
    samples/s, KL energy, reduced chi^2 and peak device memory: every latent
    finite and the reduced chi^2 in [0.5, 3];
28. ``tests/test_tomography_3d.py``'s NUTS cross-check as written: a 16^3
    field under 48 rays, geoVI (4 iterations of 4 pairs), then
    ``NUTSChain`` on the same log-probability (step 0.02, depth 8, 80
    transitions from the geoVI mean, the last 40 kept): fewer than 5 % of
    the voxels' posterior means apart by more than 3 (geoVI std + NUTS std
    + 1e-3); prints s/transition, the mean depth, the acceptance and the
    divergences;
29. ``demos/5_wiener_filter.py`` as written: 256^2, a 70 % mask, noise
    0.1, the posterior mean and a posterior sample by CG preconditioned by
    S (``resnorm`` 1e-4, at most 500 steps): relative reconstruction error
    below 0.5; prints both CG infos and the sample's std about the mean;
30. ``demos/8_parametric_vi.py`` as written: the banana posterior, 600
    Adam steps each of ``MeanFieldVI`` and ``FullCovarianceVI`` (8 mirrored
    samples), 512 samples of each: |corr_MF| < 0.35, |corr_FC| > |corr_MF|,
    the predictive mean within 0.3 of 1; prints ms per Adam step;
31. ``demos/15_vi_visualized.py`` as written, with its figure: MGVI and
    geoVI through ``optimize_kl`` (15 iterations of 20 samples at the demo's
    budgets), then 2000 steps each of ``MeanFieldVI`` and
    ``FullCovarianceVI``: each flavour's mean within 3 std of the
    grid-quadrature moments;
32. ``demos/11_model_comparison.py`` as written: two 64^2 fields (flexible
    and rigid) fitted by ``optimize_kl`` (5 iterations of 2 samples,
    ``nonlinear_resample``, ``odir`` in a temporary directory), each then
    ``estimate_evidence_lower_bound(n_eigenvalues=40)`` by ARPACK: the
    evidence prefers the flexible model; prints both ELBO intervals and
    the ARPACK matvecs with their seconds;
33. the evidence at full width: ``estimate_evidence_lower_bound(method=
    "slq")`` at the JAX package's defaults (30 steps, 8 probes, looped) on
    phase 6's 4096^2 posterior (16.8 M dof, its 8 samples): 0 <= log det
    <= n log(largest Ritz value), ``elbo_lw <= elbo_mean <= elbo_up``,
    every number finite; prints the seconds, the metric matvecs and the
    peak device memory; then on phase 5's 128^2 posterior the same
    ``HostKey`` probes in lockstep rows and looped: log-determinants
    within 1e-10 relative;
34. the NUFFT window pair (K7: the interpolation from the oversampled
    spectrum and its adjoint, the spread) against its plain versions at
    every (grid, points, rows) shape phases 4 and 35 launch (phase 35's
    eight 2048^2 w-plane grids at 1 row; phase 4's 64^2 grids at 1, 2 and
    4), in float64 and float32 (within 1e-12 / 1e-5 of the per-output sum
    of |term|), bitwise reproducible and equal to a CUDA-graph replay, with
    each kernel's registers and spills, float64 device ms beside the bound
    (the coordinates, the points' values and the grid once each: the cells
    the windows reach for the interpolation, every cell for the spread) and
    the share of it reached, the plain versions' ms and the library routes'
    (``torch.sparse.mm`` of the interpolation matrix as a complex CSR, and
    of its transpose); the factor table (each point's axis factors in CSR
    order, built once a table) within 4 ulp of its plain version, with its
    build's ms; each plane's sum blocks, fill chunks, heaviest block and
    longest lane walk; and the bits: at every shape and type both kernels'
    outputs on inputs numpy draws from a seed of the shape's label, hashed
    (SHA-256), equal to the digests pinned from the first K7 kernels
    (commit c550464), and every cell that no window reaches +0 with its
    sign bit clear;
35. radio imaging at full width: the exp of phase 8's 1024^2 field (bench
    priors, unbinned) observed by ``RadioResponse((1024, 1024), uv,
    pixsize, w, n_w_planes=8)`` (sigma 2, W 8) of 999,999 visibilities:
    earth-rotation synthesis of a 27-antenna Y-shaped array in the manner
    of the VLA's A configuration (arms of 21 km, latitude 34 degrees,
    declination 45, hour angles -4 h to +4 h in 2849 steps), the longest
    baseline at 0.45 of the grid's Nyquist frequency, complex noise of rms
    0.1 times the visibilities' rms, the truth a prior draw, the start 0.1
    times a latent draw, ``BENCH_KWARGS`` with the sample loop: the model
    built (its window tables, then its factor tables at the data draw) and
    one update, printed with its seconds, samples/s, KL energy, reduced
    chi^2 (2 dof a visibility), peak memory and K7's launches by shape;
    fails unless the K7 kernels (the factor tables, the interpolation, the
    spread) and both distributor kernels launched, every latent is finite
    and the reduced chi^2 fell;
36. the new minimizers on phase 5's 128^2 posterior: its KL from the
    samples' expansion point by ``trust_ncg``, ``lbfgs``, ``vlbfgs``,
    ``nonlinear_cg``, ``steepest_descent`` and ``minimize_scipy(method=
    "L-BFGS-B")``, 10 iterations each, each printed with its seconds,
    energy, ``nit``, ``status`` and gradient evaluations and required to
    lower the energy and stay finite; then one ``OptimizeVI.update`` with
    ``residual_map="vmap"`` whose nonlinear sample update is
    ``trust_ncg``, run by its lockstep form (finite latents, no negative
    status, the KL stage lowering the energy);
37. the mesh on the card (``nifty_tpu_torch.parallel``), in a 4-rank gloo
    world on card 0 (samples 2 x field 2; the ranks' collectives through
    the card's memory mapped by CUDA IPC, gloo carrying their barriers)
    and in an NCCL world over every card, the two worlds at once (each
    world's seconds share the card and the host with the other's): ``distributed_hartley`` and
    ``distributed_fftn``, forward and adjoint (autograd), against the
    whole field's transform on one rank (``ops.harmonic.hartley``,
    ``torch.fft``) at 4096^2, a 256^3 pencil, the 1-D four-step FFT at
    2^24 and a 4096 x 4095 field whose partner axis the ranks do not
    divide (within 1e-10 of the largest output); the 4096^2 transform's ms
    beside one rank's; each rank's slab of the 4096^2 ``n_bins=128`` map and
    its (row, bin) map, the gather bitwise and both segment sums within
    1e-12 of sum|cot| of their plain versions; ``pairwise_mean`` of 8 rows
    bitwise equal over 1, 2 and 4 ranks; and on each rank of the 2 x 2
    world K11's slab route on its rows of phase 44's 256^3 grid (a field
    drawn whole from a seed, the rank's rows taken): the ray values of
    ``integrate_slab`` (the (ray, row) partials gathered over the field
    group and folded) and the slab adjoint within 1e-12 of the per-output
    sum of |term| of the whole grid's plain versions;
38. ``demos/4_multichip.py`` through the port on the 2 x 2 world: its grid
    (64 x 32), priors, noise 0.1 and budgets (an antithetic linear draw of
    2 keys with CG 40, Newton-CG on the KL, 10 steps of CG 20), 4
    iterations; the KL energies and the posterior mode's RMS error against
    the truth, which must stay within 1.5 times the JAX demo's on 4
    virtual CPU devices (``DEMO4_JAX_RMS``);
39. phase 6's 4096^2 ``n_bins=128`` model and data at full width, field-
    and sample-sharded, under ``deterministic_reductions``: on the 2 x 2
    world and on the NCCL world (one card: 1 x 1), the energy, a metric
    matvec and a 20-step CG draw (bitwise equal between the worlds), then
    one update with ``BENCH_KWARGS`` and the sample loop: samples within
    1e-9 and KL energy within 1e-9 relative between the worlds (each
    world's whole samples hashed, and compared entry by entry where the
    hashes differ); s/update, peak memory a rank, the collectives of the
    update a rank by kind with their bytes, the distributor's launches a
    rank by map, the KL energy beside phase 6's (printed, not gated: the
    fixed-trip solvers run every step); fails unless both distributor
    kernels launched in each world's update;
40. ``optimize_kl(checkpoint_format="orbax")`` of phase 38's model on the
    2 x 2 world (``deterministic_reductions``, the maps left at "auto",
    which there loop over samples; a ``residual_map="vmap"`` draw must
    raise): two iterations, then a third continued in memory; the third
    resumed from the sharded checkpoint on a 4 x 1 world and on the NCCL
    world, each bitwise equal to the one continued in memory;
41. (run after phase 9) ``demos/7_config_file.py`` through the port: its
    INI text (section inheritance, ``n_samples = 1*1,3*2``, a ``*section``
    builder) read by ``OptimizeKLConfig``, its 64^2 field and seed 11, 4
    iterations: relative reconstruction error below 0.5, the demo's check;
    then phase 9's model, keys and budgets written as an INI file (its
    floats as their ``repr``, its key as ``seed``, ``sample_mode`` through
    a ``*section`` builder) and run by ``OptimizeKLConfig.from_file(...)
    .optimize_kl`` with ``export_operator_outputs``: its KL energy after 3
    iterations bitwise equal to phase 9's, and ``save_samples_to_fits`` of
    the signal read back equal to the host mean of the card's samples (and
    to the HDF5 export's mean); fails unless K3 and K4 launched in both;
42. (run after phase 33) ``exec_time`` of phase 6's 4096^2 ``n_bins=128``
    likelihood at its posterior position: forward, jvp, value_and_grad and
    metric ms (one warm-up call, then 3 timed, the card synchronized),
    printed with the card's name and power limit; ``CountingModel`` around
    its field through a forward, a jvp and a vjp, with its report; fails
    unless K1 and K2 launched on the 2049^2 quarter map;
43. (run after phase 6) float32 (``config.update("enable_x64", False)``,
    the JAX package's ``jax_enable_x64`` off): phase 5's 128^2 update
    (3 updates, lockstep) and phase 6's 4096^2 ``n_bins=128`` update
    (``smap``) with fields built under float32 on phase 5's and 6's data,
    each from phase 5's or 6's start and noise rounded to float32 (the
    float64 draws of their keys: ``WideKey``; a float32 draw of a seed is
    another stream); then both again in the mixed mode (``transform_compute_dtype=
    "float32"``, float64 state: phases 5's and 6's own likelihoods); then
    the port of ``tests/test_f32_acceptance.py`` at its own configuration
    (64^2, 4 iterations of 2 pairs, ``nonlinear_resample``; the data, start
    and noise of the float64 run) in float64 and in float32.  Prints s/update, the final KL
    energy beside phase 5's or 6's float64 one (pinned: 18004.496506889875
    and 300277779.29776883), working memory (the peak allocation above
    what was allocated when the run started) and the distributor kernels'
    calls by dtype; fails unless every float32 run's latents and energy are
    float32 and finite and its distributor launches (both kernels) are all
    float32, the mixed runs' all float64, and unless the acceptance run
    meets that test's criteria (rms error of the float32 posterior mean at
    most 1.1 times the float64 one's; the two means apart by at most the
    mean float64 posterior std).
44. (run with phases 37-40, in their worlds) phase 27's 256^3 model
    (``n_bins=128``, 1024 rays x 256 points), its data and noise at full
    width, field- and sample-sharded on the 2 x 2 world and on the NCCL
    world, under ``deterministic_reductions``: the correlated field on a
    rank's rows of its full-grid map (the (row, bin) map for the
    amplitude's gradient), the pencil Hartley, ``exp`` and K11 on the
    rank's slab (the ray values, data and noise whole on every rank); one
    update from phase 27's state and start at its budgets
    (``TOMO256_KWARGS``: draw CG 40, geoVI 3 x CG 15, KL 6 x CG 20, 2
    pairs), the sample loop; s/update per world, peak memory a rank, the
    collectives of the update by kind and bytes, K11's launches a rank by
    (table, rows) and the distributor's by map, the KL energy beside phase
    27's first update (printed, not gated); fails unless every rank's
    latents are finite, the two worlds' whole samples (their digest) and
    KL energies are bitwise equal, and on every rank K11 launched on its
    slab's tables in both directions, the gather on its slab's rows of the
    map and the segment sum on their (row, bin) map;
45. (run with phases 37-40) phase 19's 4100^2 chart, data and start on a
    4 x 1 gloo world and on the NCCL world, the samples sharded and the
    latents whole on every rank (ICR has no field-sharded form), under
    ``deterministic_reductions`` with the maps left at "auto" (the sample
    loop on a card mesh, checked): one update at ``MESH_ICR_KWARGS``
    (``BENCH_KWARGS``' 4 pairs, shorter fixed trips);
    s/update, peak memory, K9's launches a rank by (level, rows); fails
    unless both K9 kernels launched at every level on every rank and the
    two worlds are bitwise equal.

The port places models, latents and data on the card by default; only
phase 4's CPU run asks for the CPU (``config.update("device", "cpu")``).
Phases 5 to 16, 23 to 28, 32, 33, 35, 36 and 41 to 43 reset the kernels' launch
counts just before they drive their path and fail unless both distributor
kernels launched
(phases 11, 12 and 16: on every subgrid's map; phase 23 also both K10
kernels, phases 26 to 28 both K11 kernels, phase 28 in its geoVI run and
in its chain, phase 35 both K7 kernels); phases 18 to 21 do the same for the two refinement kernels at
every level of their field.  Phases 5 to 16 print each kernel's calls and the kernels those
calls launched (for the segment sum two a call where a bin is split, for
the gather two where a large table is first copied rows-innermost), by
rows and by map.  Any failure raises, so the exit code is nonzero and no
result line is printed.  The last two lines are a JSON object of the kernels'
numbers and the device line.  The object has one entry for each kernel,
map, number of rows and float type that the main path launched (float32:
phase 43's float32 runs; ``launches`` are the wrapper's calls with that many rows and
``kernel_launches`` the kernels those calls launched, as the wrapper summed
them from its C entry's return values in that run;
``ms``, ``plain_ms`` and ``library_ms`` are device times from CUDA-graph
replays, ``bound_ms`` the bytes of the function's inputs and output over
the card's published 3.35 TB/s); a shape the main path launched and phase
3 did not check fails the run.  The refinement kernels' entries are one
for each kernel, field level and number of rows phases 18 to 21 launched,
with phase 17's numbers (a shape phase 17 did not check fails the run);
their ``plain_ms`` is a CUDA-graph replay for the step and CUDA events for
the transpose (an autograd pull-back), ``library_ms`` the library's
route where the level is the 2-D stencil (the step ``conv2d`` +
``pixel_shuffle``, the transpose ``pixel_unshuffle`` +
``conv_transpose2d`` + ``conv2d``), else null: no PyTorch call computes
the HEALPix or radial levels' function.  K10's entries are one
for each direction and number of rows phase 23 launched, with phase 22's
numbers (a shape phase 22 did not check fails the run): ``plain_ms`` and
``table_ms`` by CUDA events, ``library_ms`` the ``torch.fft`` route (one
batched transform a distinct ring length) from a CUDA-graph replay.
K11's entries are one for each direction, table and number of rows phases
26 to 28 and 44 launched (``launches_by_run`` names the run; phase 44's
are a rank's of each field index of 2 x 2 and of 1 x 1), with phase 25's
numbers (a shape phase 25 did not check fails the run): ``plain_ms`` and
``library_ms`` by CUDA events.  K7's entries are one for each direction,
w-plane grid and number of rows phase 35 launched, with phase 34's numbers
(a shape that phase 34 did not check, in phase 35 or in phase 4's card
runs, fails the run): ``plain_ms`` and ``library_ms`` by CUDA events.

    python3 chip_smoke.py --profile

adds, after phases 5, 6, 8, 12, 15, 19, 23, 24, 27 and 35, one more update
of each config under ``torch.profiler``, and after phase 33 one more SLQ
probe at 4096^2: the device's busy share and the costliest kernels.

    python3 chip_smoke.py --witness

adds, after phase 23, the same fit with K10 and its adjoint replaced by
their ``torch.fft`` route, and prints its KL energy beside the kernel's and
the direct sum's (how far another rounding of the same ring FFTs moves the
energy).
"""

import copy
import hashlib
import json
import logging
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

N_SAMPLES = 4  # antithetic pairs -> 8 posterior samples
NOISE_STD = 0.1
# bench.py's solver budgets
BENCH_KWARGS = dict(
    n_samples=N_SAMPLES,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=50)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=5, cg_kwargs=dict(maxiter=20))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=10, cg_kwargs=dict(maxiter=30))),
    sample_mode="nonlinear_resample",
)
# Short budgets for the CPU-vs-card comparison: CG on the ill-conditioned
# metric amplifies rounding differences (another FFT, another summation
# order) by orders of magnitude per iteration, so long solves are not
# comparable at 1e-8; five CG steps are.
SHORT_KWARGS = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)
# bench.py's `bench_adaptive` budgets: absdelta controllers and the napprox
# preconditioner instead of fixed trip counts
NDOF_128 = 2 * 128 * 128
ADAPTIVE_KWARGS = dict(
    n_samples=N_SAMPLES,
    draw_linear_kwargs=dict(cg_kwargs=dict(
        maxiter=200, absdelta=1e-5 * NDOF_128), napprox=8),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=10, absdelta=1e-4 * NDOF_128,
        cg_kwargs=dict(maxiter=60))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-4, maxiter=25, absdelta=1e-4 * NDOF_128,
        cg_kwargs=dict(maxiter=100))),
    sample_mode="nonlinear_resample",
)
SEGSUM_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# NVIDIA's data sheet for the H100 SXM: device memory rate, the float32 rate
# outside the tensor cores and the float64 rate on them (outside them 34e12)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
# launch counts of three 128^2 updates with the residual stages a loop over
# samples (NVIDIA H100 80GB HBM3, 700.00 W), to print beside the lockstep ones
LOOP_COUNTS_128 = dict(gather=1516, segsum=1454)
# phase 14's seed (truth and events).  The demo's coverage check sits at
# the expectation for a calibrated posterior: with 8 samples the truth lies
# within two sample standard deviations of the sample mean on 89.9 % of the
# pixels on average (Student's t, 7 degrees of freedom), so which side of
# 0.9 a run lands on moves with the data and with the rounding of four
# short geoVI iterations (PERF.md, phase 14).  These data pass with a
# margin on the CPU and on an NVIDIA H100.
BERNOULLI_SEED = 48


def phase(name):
    """Decorator printing one line per phase with its seconds."""

    def deco(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)
            return out

        return run

    return deco


def build_field(jt, dims, n_bins=None, offset_mean=1.0, prefix="cf"):
    cfm = jt.CorrelatedFieldMaker(prefix)
    cfm.set_amplitude_total_offset(offset_mean=offset_mean, offset_std=(1e-1, 3e-2))
    kw = {} if n_bins is None else dict(n_bins=n_bins)
    cfm.add_fluctuations(
        dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1),
        asperity=(5e-1, 5e-2), **kw,
    )
    return cfm.finalize()


def build_multifrequency(jt, space_shape, n_freq):
    """`demos/10_multifrequency.py`'s model: a spatial subgrid with IWP
    deviations times a smoother frequency subgrid."""
    cfm = jt.CorrelatedFieldMaker("mf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        space_shape, distances=1.0 / space_shape[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.0, 2e-1), flexibility=(1.0, 5e-1), asperity=(5e-1, 1e-1),
        prefix="space",
    )
    cfm.add_fluctuations(
        (n_freq,), distances=1.0 / n_freq, fluctuations=(5e-1, 2e-1),
        loglogavgslope=(-4.0, 2e-1), flexibility=None, asperity=None, prefix="freq",
    )
    return cfm.finalize()


def build_field_total_n(jt):
    """Three fields (two parameter sets) on a 32^2 non-parametric subgrid
    times an 8-channel Matern subgrid."""
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        (32, 32), distances=1.0 / 32, fluctuations=(1.0, 5e-1), loglogavgslope=(-3.0, 2e-1),
        flexibility=(1e0, 5e-1), asperity=(5e-1, 5e-2), prefix="space",
    )
    cfm.add_fluctuations_matern(
        8, distances=1.0 / 8, scale=(5e-1, 2e-1), cutoff=(2.0, 1.0), loglogslope=(-3.0, 5e-1),
        renormalize_amplitude=True, prefix="freq",
    )
    return cfm.finalize(total_N=3, dofdex=[0, 0, 1])


def build_sphere(jt, lmax, harmonic_type, prefix="sky"):
    """`demos/16_spherical_cf.py`'s field on a HEALPix (default nside (lmax +
    1) // 2) or Gauss-Legendre grid: offset (0, (0.3, 0.1)), fluctuations
    (1, 0.5), slope (-3, 0.2), flexibility (1, 0.5)."""
    cfm = jt.CorrelatedFieldMaker(prefix)
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(3e-1, 1e-1))
    cfm.add_fluctuations(lmax, distances=1.0, harmonic_type=harmonic_type,
                         fluctuations=(1.0, 5e-1), loglogavgslope=(-3.0, 2e-1),
                         flexibility=(1e0, 5e-1))
    return cfm.finalize()


def build_bench_sphere(jt, lmax):
    """`bench.py`'s amplitude priors on a Gauss-Legendre sphere."""
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(lmax, distances=1.0, harmonic_type="spherical",
                         fluctuations=(1.0, 5e-1), loglogavgslope=(-3.0, 2e-1),
                         flexibility=(1e0, 5e-1), asperity=(5e-1, 5e-2))
    return cfm.finalize()


def matern32(scale=1.0):
    """The Matern-3/2 covariance of a tensor of distances."""
    return lambda r: (1.0 + r / scale) * torch.exp(-r / scale)


def warp_2d(reg):
    """Phase 4's deformation of a 2-D chart: a sine stretch of axis 0."""
    return np.stack([reg[..., 0] + 0.3 * np.sin(reg[..., 0]), reg[..., 1]], axis=-1)


def build_likelihood(jt, model, key, noise_std=NOISE_STD):
    """bench.py's `_build`: synthetic data from the prior plus white noise."""
    k1, k2 = jt.split(key, 2)
    with torch.no_grad():
        truth = model(model.init(k1))
        data = truth + noise_std * jt.random_like(k2, truth)
    return jt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std ** 2).amend(model)


def pointwise(jt, field, fn):
    """`fn` of a field's values as a model; the field is a submodule, so the
    model moves with it."""

    class Pointwise(jt.Model):
        def __init__(self):
            super().__init__(domain=field.domain, init=field.init)
            self.field = field

        def forward(self, x):
            return fn(self.field(x))

    return Pointwise()


def poisson_likelihood(jt, field, key, seed=0, counts=None):
    """Poisson counts on the rates exp(field): rates from the prior (`key`)
    and counts drawn with numpy from `seed`, or the `counts` given.  Returns
    the likelihood, the true rates and the counts (numpy)."""
    lam = pointwise(jt, field, torch.exp)
    with torch.no_grad():
        truth = lam(lam.init(key))
    if counts is None:
        counts = np.random.default_rng(seed).poisson(truth.cpu().numpy())
    data = torch.from_numpy(counts).to(jt.config.default_device())
    return jt.Poissonian(data).amend(lam), truth, counts


def build_poisson_demo_field(jt, dims):
    """`demos/2_poisson_counts.py`'s field: a power law without deviations."""
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=2.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1))
    return cfm.finalize()


def build_bernoulli_demo_field(jt, dims):
    """`demos/14_bernoulli_map.py`'s field, with integrated-Wiener-process
    deviations from the power law."""
    cfm = jt.CorrelatedFieldMaker("sky")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(dims, distances=1.0 / dims[0], fluctuations=(1.5, 0.3),
                         loglogavgslope=(-3.5, 0.2), flexibility=(1.0, 0.5),
                         asperity=(0.5, 0.1))
    return cfm.finalize()


def density_counts():
    """`demos/6_density_estimation.py`'s data: 1500 events from two normal
    modes on [0, 1), binned to 128 counts."""
    rng = np.random.default_rng(3)
    events = np.concatenate([rng.normal(0.3, 0.05, 750), rng.normal(0.7, 0.1, 750)])
    events = events[(events >= 0) & (events < 1)]
    return np.histogram(events, bins=128, range=(0.0, 1.0))[0]


def start(jt, lh, kwargs, key=7, pos_key=1, **maps):
    """bench.py's start: optimizer, state from key `key`, position from
    `pos_key`; `maps`: OptimizeVI's residual_map / kl_map."""
    opt = jt.OptimizeVI(lh, n_total_iterations=100, **maps)
    state = opt.init_state(key, **kwargs)
    samples = jt.Samples(pos=jt.random_like(pos_key, lh.domain), samples=None, keys=None)
    return opt, samples, state


def synchronize(jt):
    if jt.config.default_device().type == "cuda":
        torch.cuda.synchronize()


def run_updates(jt, lh, n_updates, kwargs, key=7, pos_key=1, **maps):
    """`n_updates` updates from bench.py's start, each timed to a synchronize."""
    opt, samples, state = start(jt, lh, kwargs, key, pos_key, **maps)
    seconds = []
    for _ in range(n_updates):
        synchronize(jt)
        t0 = time.perf_counter()
        samples, state = opt.update(samples, state)
        synchronize(jt)
        seconds.append(time.perf_counter() - t0)
    return samples, state, seconds


#: the milliseconds a timing spends on one function's timed calls at most:
#: a function slower than this over `n` calls (a plain version, some
#: library calls) is timed over fewer, at least 2, which costs seconds
#: instead of tens of them and moves no kernel's time
TIMING_BUDGET_MS = 250.0


def probe_ms(fn):
    """Milliseconds of one call of `fn` after 3 warm-up calls (CUDA events)."""
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def within_budget(ms, n):
    """`n`, or fewer calls (at least 2) where `n` calls of `ms` each would
    take more than `TIMING_BUDGET_MS`."""
    return n if ms * n <= TIMING_BUDGET_MS else max(2, int(TIMING_BUDGET_MS / ms))


def cuda_ms(fn, n=50):
    """Mean milliseconds per call of `fn` over `n` back-to-back calls (fewer
    for a slow function: `within_budget`), CUDA events: at small sizes this
    is how fast the host issues the calls."""
    n = within_budget(probe_ms(fn), n)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def host_paced_ms(kernel, plain, n=50):
    """`cuda_ms` of a kernel and its plain version in turns (kernel, plain,
    plain, kernel); the mean of each pair."""
    k1, p1, p2, k2 = (cuda_ms(fn, n) for fn in (kernel, plain, plain, kernel))
    return (k1 + k2) / 2, (p1 + p2) / 2


def captured(fn, n=1):
    """A CUDA graph of `n` calls of `fn` (warmed up off the capture stream)
    and the last call's output.  Every other call's output is dropped at
    once, so the calls write the same memory.  (Keeping each output until
    the next call alternates between two buffers, 67 MB at 4096^2 for the
    gather, beyond what L2 holds; that took the gather 15 % longer.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n - 1):
            fn()
        out = fn()
    return graph, out


def replayed(fn):
    """`fn`'s output (a tensor or a tuple of them), computed by replaying a
    CUDA graph of one call."""
    graph, out = captured(fn)
    graph.replay()
    torch.cuda.synchronize()
    return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()


def device_ms(fn, n=50, replays=3):
    """Mean device milliseconds per call of `fn`: its `n` calls captured in
    one CUDA graph, replayed `replays` times between CUDA events (for a
    slow function fewer calls, `within_budget`, replayed once).  The device
    runs the calls back to back without waiting on the host."""
    ms = probe_ms(fn)
    if ms * n * replays > TIMING_BUDGET_MS:
        n, replays = within_budget(ms, n), 1
    graph, _ = captured(fn, n)
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * n)


@phase("1 device")
def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    # full float32 matrix products and convolutions wherever the port
    # runs on CUDA (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} cards {torch.cuda.device_count()}", flush=True)
    return line


def start_builds():
    """Start one compiler a source, all together: the five CUDA libraries
    and the host's HEALPix core, each in a thread of its own.  Returns the
    jobs and their start time; :func:`phase_build` waits for them.  Until
    then nothing may call a kernel or the HEALPix core (each loads its
    library at first use), so only host set-up that touches neither runs
    meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops import healpix, hp_longitude, icr_refine, los_interp, nufft_window

    builds = (bg._kernels, icr_refine._kernels, hp_longitude._kernels, los_interp._kernels,
              nufft_window._kernels, healpix._lib)
    pool = ThreadPoolExecutor(len(builds))
    jobs = [pool.submit(fn) for fn in builds]
    pool.shutdown(wait=False)
    return jobs, time.perf_counter()


@phase("2 build kernels (the wait for them after the host set-up they overlap)")
def phase_build(started):
    """Wait for :func:`start_builds`' jobs; print each build's seconds and
    its kernels' registers and spills."""
    from nifty_tpu_torch.ops.cuda_build import BUILD_LOG

    jobs, t0 = started
    for job in jobs:
        job.result()
    print(f"kernel build+load {time.perf_counter() - t0:.3f} s", flush=True)
    for name, (secs, log) in BUILD_LOG.items():
        print(f"build {name}: {secs:.3f} s", flush=True)
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print("  " + line.strip(), flush=True)


@phase("3 kernels vs plain")
def phase_kernels(cases, f32=()):
    """`cases`: {label: (BinIndex on the card, batch rows)}, or (BinIndex,
    rows, calls a timing): the mesh phases' maps, float64 alone (their
    type) with 10 calls a timing (3 for 256^3's, whose plain segment sum
    takes 68-117 ms a call).  A map of a million entries a call or
    more is timed over 10 calls (its plain segment sum takes up to 46 ms a
    call), a smaller one over 50.  Every case is held in both types; float32
    is timed at the labels in `f32`, the shapes the float32 runs (phases 43
    and 46) launch."""
    from nifty_tpu_torch.ops import bin_gather as bg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    for label, (dist, nrows, *calls) in cases.items():
        n = calls[0] if calls else (10 if dist.n * nrows >= 2 ** 20 else 50)
        for dtype in (torch.float64,) if calls else (torch.float64, torch.float32):
            table = torch.randn((nrows, dist.nb), dtype=dtype, device=dev, generator=gen)
            cot = torch.randn((nrows, dist.n), dtype=dtype, device=dev, generator=gen)
            kernels_before = bg.bin_gather.kernel_launches
            got = bg.bin_gather(table, dist)
            gather_kernels = bg.bin_gather.kernel_launches - kernels_before
            want = bg.bin_gather_plain(table, dist.idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"bin_gather differs from its plain version ({label}, {dtype})")
            g_err = float((got - want).abs().max())

            kernels_before = bg.bin_segment_sum.kernel_launches
            s1 = bg.bin_segment_sum(cot, dist)
            segsum_kernels = bg.bin_segment_sum.kernel_launches - kernels_before
            s2 = bg.bin_segment_sum(cot, dist)
            plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
            scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets)
            torch.cuda.synchronize()
            if not torch.equal(s1, s2):
                raise AssertionError(f"bin_segment_sum is not reproducible ({label}, {dtype})")
            s_graph = replayed(lambda: bg.bin_segment_sum(cot, dist))
            if not torch.equal(s1, s_graph):
                raise AssertionError(
                    f"bin_segment_sum differs when replayed from a CUDA graph ({label}, {dtype})")
            # the short classes' narrow butterflies must give the bits of a
            # whole warp a bin
            if not torch.equal(s1, bg.bin_segment_sum_whole_warps(cot, dist)):
                raise AssertionError(
                    f"bin_segment_sum differs from a whole warp a short bin ({label}, {dtype})")
            if not torch.equal(got, replayed(lambda: bg.bin_gather(table, dist))):
                raise AssertionError(
                    f"bin_gather differs when replayed from a CUDA graph ({label}, {dtype})")
            s_err = float((s1 - plain).abs().max())
            rel = float(((s1 - plain).abs() / scale.clamp_min(torch.finfo(dtype).tiny)).max())
            if rel > SEGSUM_RTOL[dtype]:
                raise AssertionError(
                    f"bin_segment_sum off by {rel:.3e} of sum|cot| ({label}, {dtype})"
                )
            gather, gather_plain = (lambda: bg.bin_gather(table, dist),
                                    lambda: bg.bin_gather_plain(table, dist.idx))
            segsum, segsum_plain = (lambda: bg.bin_segment_sum(cot, dist),
                                    lambda: bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets))

            # the one PyTorch call that computes the segment sum from the same
            # inputs; the port never calls it.  (For the gather that call is
            # `index_select`, which is the plain version itself.)
            def segsum_library():
                return cot.new_zeros((nrows, dist.nb)).index_add_(1, dist.idx, cot)

            lib = segsum_library()
            lib_rel = float(((lib - plain).abs() / scale.clamp_min(torch.finfo(dtype).tiny)).max())
            if lib_rel > 10 * SEGSUM_RTOL[dtype]:
                raise AssertionError(f"index_add_ disagrees with the plain version ({label})")
            if dtype == torch.float32 and label not in f32:
                continue
            times = {}
            times["gather_ms"], times["gather_plain_ms"] = host_paced_ms(gather, gather_plain, n)
            times["segsum_ms"], times["segsum_plain_ms"] = host_paced_ms(segsum, segsum_plain, n)
            for kind, fn in (("gather", gather), ("gather_plain", gather_plain),
                             ("segsum", segsum), ("segsum_plain", segsum_plain),
                             ("segsum_library", segsum_library)):
                times[f"{kind}_device_ms"] = device_ms(fn, n)
            times["gather_library_device_ms"] = times["gather_plain_device_ms"]
            # the least the card could take: every input of the function
            # read once (the values and the index map at its narrow width;
            # the sort permutation and the work items are the kernel's own
            # means, not the function's inputs), every output written once,
            # over the memory rate; the segment sum's additions over the
            # arithmetic rate
            size = table.element_size()
            index_bytes = dist.n * dist.idx_narrow.element_size()
            gather_bytes = nrows * dist.nb * size + index_bytes + nrows * dist.n * size
            segsum_bytes = nrows * dist.n * size + index_bytes + nrows * dist.nb * size
            times["gather_bound_ms"] = 1e3 * gather_bytes / PEAK_BYTES_PER_S
            times["gather_bound_by"] = "bytes"
            by_bytes = 1e3 * segsum_bytes / PEAK_BYTES_PER_S
            by_adds = 1e3 * nrows * dist.n / PEAK_OPS_PER_S[dtype]
            times["segsum_bound_ms"] = max(by_bytes, by_adds)
            times["segsum_bound_by"] = "bytes" if by_bytes >= by_adds else "operations"
            key = (label, str(dtype).replace("torch.", ""))
            results[key] = dict(gather_err=g_err, segsum_err=s_err, segsum_rel=rel, **times)
            print(
                f"{label} {key[1]}: table ({nrows}, {dist.nb}) x map {dist.shape} "
                f"(index {str(dist.idx_narrow.dtype).replace('torch.', '')}) | ms per call, "
                f"host-paced / device: gather {times['gather_ms']:.4f} / "
                f"{times['gather_device_ms']:.4f} (plain {times['gather_plain_ms']:.4f} / "
                f"{times['gather_plain_device_ms']:.4f}) | segment sum {times['segsum_ms']:.4f} / "
                f"{times['segsum_device_ms']:.4f} (plain {times['segsum_plain_ms']:.4f} / "
                f"{times['segsum_plain_device_ms']:.4f}; index_add_ "
                f"{times['segsum_library_device_ms']:.4f}) rel err {rel:.2e} | bound ms gather "
                f"{times['gather_bound_ms']:.5f} segment sum {times['segsum_bound_ms']:.5f} | "
                f"segment sum "
                f"work items {dist.n_items} ({dist.n_short} short bins: "
                + ", ".join(f"{c} of {w} lanes" for c, w in zip(dist.short_counts,
                                                                 bg.SHORT_WIDTHS))
                + f"; in {dist.n_pieces} pieces), split bins "
                f"{dist.n_split}, C = {bg.SEGMENT_CHUNK} | kernels the checked call launched, as "
                f"its C entry returned: gather {gather_kernels}, segment sum {segsum_kernels}",
                flush=True,
            )
    return results


@phase("4 32^2, 32^2 x Matern 8 (total_N=3), 32^2 Poissonian, a Poissonian + Gaussian sum, "
       "two ICR fields, two spherical fields, a 16^3 tomography, 32^2 radio imaging and the "
       "32^2 KL by trust_ncg and lbfgs: updates, CPU vs card, sample loop and lockstep; the "
       "Wiener filter and the SLQ evidence on the 32^2 field")
def phase_cpu_vs_card(jt):
    """Each case of :func:`cpu_vs_card_cases`, one update in the sample loop
    and in lockstep, on the CPU (in a process of its own, while this one
    runs the card's updates) and on the card: KL energies within 1e-8
    relative.  Then the Wiener filter and the SLQ evidence.  Returns K7's
    counts of the card's runs (its radio case)."""
    from nifty_tpu_torch.ops import nufft_window as nw

    counts = poisson_counts(jt)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu = pool.apply_async(cpu_side_energies, (counts,))
        cases = cpu_vs_card_cases(jt, counts)
        nw.reset_launch_counts()
        card = {}
        for name, (build, kwargs) in cases.items():
            for rmap in ("smap", "vmap"):
                _, state, secs = run_updates(jt, build(), 1, kwargs, key=jt.HostKey(7),
                                             pos_key=jt.HostKey(1), residual_map=rmap)
                card[name, rmap] = float(state.minimization_state.fun), secs[0]
        cpu = cpu.get(timeout=1200)
    for name, rmap in card:
        energies = {"cpu": cpu[name, rmap][0], "cuda": card[name, rmap][0]}
        for dev, (energy, sec) in (("cpu", cpu[name, rmap]), ("cuda", card[name, rmap])):
            print(f"{name} {rmap} on {dev}: KL energy {energy!r} in {sec:.3f} s", flush=True)
        rel = abs(energies["cuda"] - energies["cpu"]) / abs(energies["cpu"])
        print(f"{name} {rmap} CPU vs card relative energy difference {rel:.3e}", flush=True)
        if not rel <= 1e-8:
            raise AssertionError(
                f"CPU and card disagree ({name}, {rmap}): relative {rel:.3e} > 1e-8")
    k7 = k7_counts()
    print(f"phase 4 K7 calls on the card: {k7_text(k7)}", flush=True)
    require_k7_launches("32^2 radio on the card", k7)
    wiener_and_evidence_cpu_vs_card(jt)
    return k7


#: intra-op threads of phase 4's CPU process, which runs beside the card's
#: updates (their host thread keeps a core)
CPU_SIDE_THREADS = 6


def poisson_counts(jt):
    """Phase 4's Poisson fields' counts, drawn on the CPU's rates."""
    jt.config.update("device", "cpu")  # the CPU only because it is asked for
    try:
        return {prefix: poisson_likelihood(jt, build_field(jt, (32, 32), prefix=prefix),
                                           jt.HostKey(3))[2] for prefix in ("pois",)}
    finally:
        jt.config.update("device", "cuda")


def cpu_side_energies(counts):
    """Phase 4's CPU side, in a process of its own: each case's KL energy
    and seconds after one update, by (case, map)."""
    import nifty_tpu_torch as jt

    jt.logger.setLevel(logging.WARNING)
    jt.config.update("device", "cpu")  # the CPU only because it is asked for
    torch.set_num_threads(CPU_SIDE_THREADS)
    out = {}
    for name, (build, kwargs) in cpu_vs_card_cases(jt, counts).items():
        for rmap in ("smap", "vmap"):
            _, state, secs = run_updates(jt, build(), 1, kwargs, key=jt.HostKey(7),
                                         pos_key=jt.HostKey(1), residual_map=rmap)
            out[name, rmap] = float(state.minimization_state.fun), secs[0]
    return out


def cpu_vs_card_cases(jt, counts):
    """Phase 4's cases, {name: (likelihood builder, update budgets)}, on the
    configured device; the Poisson fields' counts given (numpy, by
    prefix)."""
    from nifty_tpu_torch.solvers.lbfgs import _lbfgs
    from nifty_tpu_torch.solvers.trust_ncg import _trust_ncg

    def poisson(prefix):
        return poisson_likelihood(jt, build_field(jt, (32, 32), prefix=prefix), jt.HostKey(3),
                                  counts=counts[prefix])[0]

    likelihoods = {
        "32^2": lambda: build_likelihood(jt, build_field(jt, (32, 32)), jt.HostKey(0)),
        "32^2 x Matern 8, total_N=3": lambda: build_likelihood(
            jt, build_field_total_n(jt), jt.HostKey(0)),
        "32^2 Poissonian": lambda: poisson("pois"),
        # a sum over the dict domain of two fields: Poisson counts on one,
        # a Gaussian on the other
        "32^2 Poissonian + 32^2 Gaussian": lambda: poisson("pois") + build_likelihood(
            jt, build_field(jt, (32, 32), prefix="gaus"), jt.HostKey(0)),
        # ICR: a deformed 2-D chart (20^2) and sphere x radius (192 x 8).
        # Kernel scales of a pixel or less: with smoother kernels the
        # posterior is so ill-conditioned that five CG steps amplify
        # rounding past 1e-8 (on the CPU alone, the sample loop and the
        # lockstep stages end 4e-9 apart at scale 1 on the chart).
        "20^2 deformed ICR chart": lambda: build_likelihood(jt, jt.RefinementField(
            jt.CoordinateChart((8, 8), depth=2, distances0=1.0, nonlinear_map=warp_2d),
            matern32(0.5)), jt.HostKey(0)),
        "sphere x radius ICR (192 x 8)": lambda: build_likelihood(jt, jt.RefinementHPField(
            jt.HEALPixChart(1, depth=2, radial_chart=jt.CoordinateChart(
                5, depth=2, distances0=0.5, nonlinear_map=lambda x: 1.0 + x)),
            matern32(0.3)), jt.HostKey(0)),
        # spherical fields with demo 16's priors: Gauss-Legendre (17 x 34)
        # and HEALPix (nside 8, 768 pixels; K10 on the card)
        "Gauss-Legendre sphere lmax 16": lambda: build_likelihood(
            jt, build_sphere(jt, 16, "spherical"), jt.HostKey(0)),
        "HEALPix sphere lmax 15, nside 8": lambda: build_likelihood(
            jt, build_sphere(jt, 15, "healpix"), jt.HostKey(0)),
        # line-of-sight tomography (K11 on the card)
        "16^3 tomography, 32 rays x 32 points": lambda: build_tomography(
            jt, (16, 16, 16), 32, 32, NUTS_SEED, 4)[0],
        # radio imaging (K7 on the card): phase 35's model at 32^2 with 4000
        # visibilities of 12 steps of its earth-rotation synthesis
        "32^2 radio, 4000 visibilities in 8 w-planes": lambda: build_radio(
            jt, build_field(jt, (32, 32)), (32, 32), 12, jt.HostKey(RADIO_SEED), n_vis=4000)[0],
        # the first case with its KL stage minimized by the new minimizers
        "32^2, KL by trust_ncg": (
            lambda: build_likelihood(jt, build_field(jt, (32, 32)), jt.HostKey(0)),
            dict(SHORT_KWARGS, kl_kwargs=dict(minimize=_trust_ncg, minimize_kwargs=dict(
                maxiter=3, subproblem_kwargs=dict(maxiter=5))))),
        "32^2, KL by lbfgs": (
            lambda: build_likelihood(jt, build_field(jt, (32, 32)), jt.HostKey(0)),
            dict(SHORT_KWARGS, kl_kwargs=dict(minimize=_lbfgs, minimize_kwargs=dict(maxiter=3)))),
    }
    return {name: case if isinstance(case, tuple) else (case, SHORT_KWARGS)
            for name, case in likelihoods.items()}


def demo5_operators(dims, device):
    """`demos/5_wiener_filter.py`'s prior on `dims`: a power-law spectrum on
    the harmonic grid, floored at 1e-3 of its peak, normalized to unit
    pointwise variance.  Returns S^{1/2}, S^{-1}, S^{-1/2} and S (the CG
    preconditioner)."""
    from nifty_tpu_torch.ops.harmonic import fourier_mode_lengths, hartley

    k = torch.as_tensor(fourier_mode_lengths(dims, 1.0 / dims[0]), device=device)
    amp = torch.where(k == 0.0, torch.ones_like(k), (1.0 + (k / 4.0) ** 2) ** (-3.0 / 2.0))
    amp = torch.clamp_min(amp, 1e-3 * amp.max())
    npix = float(np.prod(dims))
    amp = amp / torch.sqrt(torch.sum(amp ** 2)) * npix
    root = np.sqrt(npix)
    return dict(
        S_sqrt=lambda xi: hartley(amp * xi) / root,
        S_inv=lambda s: hartley(hartley(s) / root / amp ** 2) / root,
        S_inv_sqrt=lambda xi: hartley(xi / amp) / root,
        S_apply=lambda x: hartley(hartley(x) / root * amp ** 2) / root,
    )


def uniform(generator, shape, dtype, device):
    """Uniform draws on [0, 1), an `rng` for `random_like`."""
    return torch.rand(shape, generator=generator, dtype=dtype, device=device)


def wiener_and_evidence_cpu_vs_card(jt):
    """Phase 4's first case (the 32^2 field, its data from `HostKey(0)`) on
    the CPU and on the card: `wiener_filter` of its data through a 70 %
    mask under demo 5's prior (20 CG steps preconditioned by S: longer
    solves amplify rounding past 1e-8, see tests/test_torch_wiener_filter.py)
    with the posterior means within 1e-8 relative, and
    `estimate_evidence_lower_bound(method="slq")` (30 Lanczos steps, 8
    probes in lockstep, `HostKey` probes) on the CPU's posterior after one
    update, the same samples on both devices, with `elbo_mean` within 1e-8
    relative."""
    means, elbo = {}, {}
    noise_std = NOISE_STD
    for dev in ("cpu", "cuda"):
        jt.config.update("device", dev)  # the CPU only because it is asked for
        try:
            lh = build_likelihood(jt, build_field(jt, (32, 32)), jt.HostKey(0))
            data = lh.likelihood.data
            ops = demo5_operators((32, 32), data.device)
            mask = (jt.random_like(jt.HostKey(5), data, rng=uniform) > 0.3).to(data.dtype)
            means[dev], info = jt.wiener_filter(
                data * mask, lambda s: s * mask, lambda d: d / noise_std ** 2, ops["S_inv"],
                domain_proto=data, cg_kwargs=dict(resnorm=1e-4, maxiter=20,
                                                  preconditioner=ops["S_apply"]))
            if dev == "cpu":
                samples, _, _ = run_updates(jt, lh, 1, SHORT_KWARGS, key=jt.HostKey(7),
                                            pos_key=jt.HostKey(1), residual_map="smap")
                pos, resid = jt.to_numpy(samples.pos), jt.to_numpy(samples._samples)
            on_dev = jt.Samples(pos=jt.from_numpy(pos), samples=jt.from_numpy(resid))
            _, stats = jt.estimate_evidence_lower_bound(
                lh, on_dev, 0, method="slq", key=jt.HostKey(4), verbose=False)
            elbo[dev] = float(stats["elbo_mean"])
        finally:
            jt.config.update("device", "cuda")
        print(f"32^2 Wiener filter on {dev}: CG info {info} | SLQ evidence on {dev}: elbo_mean "
              f"{elbo[dev]!r}, log det {stats['logdet']!r}", flush=True)
    a, b = means["cpu"], means["cuda"].cpu()
    rel_wf = float(torch.linalg.vector_norm(b - a) / torch.linalg.vector_norm(a))
    rel_elbo = abs(elbo["cuda"] - elbo["cpu"]) / abs(elbo["cpu"])
    print(f"32^2 CPU vs card: Wiener filter mean relative difference {rel_wf:.3e} | SLQ "
          f"elbo_mean relative difference {rel_elbo:.3e}", flush=True)
    if not (rel_wf <= 1e-8 and rel_elbo <= 1e-8):
        raise AssertionError(f"CPU and card disagree on the 32^2 Wiener filter ({rel_wf:.3e}) "
                             f"or the SLQ evidence ({rel_elbo:.3e}) beyond 1e-8")


def launch_counts(bg):
    """The wrappers' counts: calls of the kernel route, the kernels those
    calls launched (the C entries' return values), and both by the calls'
    number of rows."""
    counts = {}
    for kind, fn in (("gather", bg.bin_gather), ("segsum", bg.bin_segment_sum)):
        counts[kind] = fn.launches
        counts[f"{kind}_kernels"] = fn.kernel_launches
        counts[f"{kind}_by_rows"] = dict(fn.launches_by_rows)
        counts[f"{kind}_kernels_by_rows"] = dict(fn.kernel_launches_by_rows)
        counts[f"{kind}_by_map"] = dict(fn.launches_by_map)
        counts[f"{kind}_kernels_by_map"] = dict(fn.kernel_launches_by_map)
        counts[f"{kind}_by_dtype"] = dict(fn.launches_by_dtype)
    return counts


def on_map(counts, key, dist):
    """`counts[key]` (a count by map and rows) of the map `dist`, by rows."""
    return {rows: n for (shape, nb, rows), n in counts[key].items()
            if (shape, nb) == (dist.shape, dist.nb)}


def require_launches(label, counts, maps=()):
    """Both kernels launched (on each of `maps`), and the counts by rows and
    by map add up to the totals."""
    if min(counts["gather"], counts["segsum"], counts["gather_kernels"],
           counts["segsum_kernels"]) <= 0:
        raise AssertionError(f"{label}: a distributor kernel never launched: {counts}")
    for kind in ("gather", "segsum"):
        for by in ("rows", "map"):
            if (sum(counts[f"{kind}_by_{by}"].values()) != counts[kind]
                    or sum(counts[f"{kind}_kernels_by_{by}"].values())
                    != counts[f"{kind}_kernels"]):
                raise AssertionError(f"{label}: the counts by {by} do not add up: {counts}")
        for dist in maps:
            if sum(on_map(counts, f"{kind}_by_map", dist).values()) <= 0:
                raise AssertionError(
                    f"{label}: {kind} never launched on the map {dist.shape}: {counts}")


def rows_text(counts):
    """Each kernel's calls by rows, with the kernels they launched."""
    return " ".join(f"{kind} " + ", ".join(
        f"B={b}: {n} ({counts[f'{kind}_kernels_by_rows'][b]} kernels)"
        for b, n in sorted(counts[f"{kind}_by_rows"].items())) for kind in ("gather", "segsum"))


def maps_text(counts):
    """Each kernel's calls by map (shape, bins) and rows, with the kernels
    they launched."""
    return " ".join(f"{kind} " + ", ".join(
        f"{shape} {nb} bins B={b}: {n} ({counts[f'{kind}_kernels_by_map'][shape, nb, b]} kernels)"
        for (shape, nb, b), n in sorted(counts[f"{kind}_by_map"].items()))
        for kind in ("gather", "segsum"))


def drive(jt, label, lh, n_updates, kwargs=BENCH_KWARGS, subgrid_maps=(), **maps):
    """Run the main path with the launch counts reset just before; returns
    the counts, the final KL energy and the samples.  Fails unless both
    kernels launched, on each of `subgrid_maps` too."""
    from nifty_tpu_torch.ops import bin_gather as bg

    torch.cuda.reset_peak_memory_stats()
    bg.reset_launch_counts()
    samples, state, secs = run_updates(jt, lh, n_updates, kwargs, **maps)
    counts = launch_counts(bg)
    energy = float(state.minimization_state.fun)
    med = sorted(secs)[len(secs) // 2]
    print(
        f"{label}: s/update {[round(s, 3) for s in secs]} median {med:.3f} | "
        f"geoVI samples/s {2 * N_SAMPLES / med:.4f} | KL energy {energy!r} | "
        f"launches gather {counts['gather']} (calls; {counts['gather_kernels']} kernels) "
        f"segment_sum {counts['segsum']} (calls; {counts['segsum_kernels']} kernels), by rows "
        f"of the table: "
        f"{rows_text(counts)} | "
        + (f"by map: {maps_text(counts)} | " if subgrid_maps else "")
        + f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
        f"last KL Newton steps {int(state.minimization_state.nit)}, geoVI steps per "
        f"sample {state.sample_state.nit.tolist()}",
        flush=True,
    )
    if not torch.isfinite(torch.tensor(energy)):
        raise AssertionError(f"{label}: non-finite KL energy {energy}")
    require_launches(label, counts, subgrid_maps)
    return counts, energy, samples


@phase("7 128^2 adaptive (absdelta, napprox=8), 3 updates")
def phase_adaptive(jt, lh, fixed_energy):
    """bench.py's `bench_adaptive` configuration; the draw CG is wrapped so
    that its per-sample step counts can be printed."""
    from nifty_tpu_torch.solvers.cg import _static_cg_batched

    draw_steps = []

    def counting_cg(mat, j, x0=None, **kw):
        res = _static_cg_batched(mat, j, x0, **kw)
        draw_steps.append(res.nit.tolist())
        return res.x, res.info

    kwargs = dict(ADAPTIVE_KWARGS)
    kwargs["draw_linear_kwargs"] = dict(ADAPTIVE_KWARGS["draw_linear_kwargs"], cg=counting_cg)
    counts, energy, _ = drive(jt, "128^2 adaptive", lh, 3, kwargs, residual_map="vmap")
    rel = abs(energy - fixed_energy) / max(abs(fixed_energy), 1e-12)
    print(f"128^2 adaptive: draw CG steps per sample and update {draw_steps} | KL energy "
          f"{energy!r} against the fixed budgets' {fixed_energy!r}: relative {rel:.5f}",
          flush=True)
    if not rel < 0.02:
        raise AssertionError(
            f"adaptive KL energy {energy} is not within 2 % of the fixed budgets' {fixed_energy}")
    return counts


# tests/test_f32_acceptance.py's configuration: 64^2, 4 iterations of 2
# antithetic pairs, its solver budgets
ACCEPTANCE_KWARGS = dict(
    n_samples=2,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=100, absdelta=1e-11)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-6, maxiter=5, cg_kwargs=dict(maxiter=40))),
    kl_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-7, maxiter=15, cg_kwargs=dict(maxiter=60))),
    sample_mode="nonlinear_resample",
)
class WideKey:
    """A noise provider for the float32 runs (phases 43 and 46): the draws
    of `key` (an int seed, or a noise provider such as `HostKey`) in
    float64 (complex128 for a complex leaf), as the float64 phases draw
    them, rounded to each leaf's dtype.  A float32 run with these keys
    starts from the float64 run's position and noise, rounded; a float64
    run sees the key's own bits."""

    def __init__(self, jt, key):
        self.jt, self.key = jt, key if not isinstance(key, (int, np.integer)) else int(key)

    def split(self, num=2):
        return [WideKey(self.jt, k) for k in self.jt.tree.split(self.key, num)]

    def fold_in(self, data):
        return WideKey(self.jt, self.jt.tree.fold_in(self.key, data))

    def normal(self, primals, device=None):
        return self.draw(primals, self.jt.tree.normal, device=device)

    def draw(self, primals, rng, device=None):
        t = self.jt.tree
        wide = t.tree_map(lambda x: t.ShapeWithDtype(
            x.shape, torch.complex128 if x.dtype.is_complex else torch.float64), primals)
        device = device if device is not None else t.tree_device(primals)
        return t.tree_map(lambda d, x: d.to(x.dtype),
                          t.random_like(self.key, wide, rng, device=device), primals)


def require_dtype(label, counts, dtype):
    """Every distributor call of the run took `dtype` values ("f32" or
    "f64")."""
    for kind in ("gather", "segsum"):
        if counts[f"{kind}_by_dtype"] != {dtype: counts[kind]}:
            raise AssertionError(f"{label}: {kind} calls by dtype "
                                 f"{counts[f'{kind}_by_dtype']}, not all {dtype}")


def dtype_text(counts):
    return " ".join(f"{kind} {counts[f'{kind}_by_dtype']}" for kind in ("gather", "segsum"))


def acceptance_run(jt, x64, store, dims=(64, 64), n_iter=4):
    """`tests/test_f32_acceptance.py`'s `_run` in the port: the flagship
    correlated-field geoVI flow through `optimize_kl`, the data drawn once
    by the float64 run (a seeded numpy latent and noise), the start and
    the noise the float64 draws of the keys (`WideKey`); returns the
    posterior mean and std (as float64 numpy), the launch counts, the KL
    energy and the seconds."""
    from nifty_tpu_torch.ops import bin_gather as bg

    jt.config.update("enable_x64", x64)
    cf = build_field(jt, dims)
    if "data" not in store:
        rng = np.random.default_rng(0)
        with torch.no_grad():
            truth = cf(jt.from_numpy({k: rng.standard_normal(v.shape)
                                      for k, v in cf.domain.items()})).cpu().numpy()
        store["truth"] = truth
        store["data"] = truth + 0.1 * rng.standard_normal(truth.shape)
    lh = jt.Gaussian(store["data"], noise_cov_inv=lambda x: x / 0.01).amend(cf)
    bg.reset_launch_counts()
    synchronize(jt)
    t0 = time.perf_counter()
    samples, state = jt.optimize_kl(
        lh, jt.random_like(WideKey(jt, 3), lh.domain), key=WideKey(jt, 42),
        n_total_iterations=n_iter, plot_energy_history=False, **ACCEPTANCE_KWARGS)
    synchronize(jt)
    secs = time.perf_counter() - t0
    counts = launch_counts(bg)
    with torch.no_grad():
        post = torch.stack([cf(s) for s in samples])
    want = torch.float64 if x64 else torch.float32
    if post.dtype != want or not bool(torch.isfinite(post).all()):
        raise AssertionError(f"acceptance run in {want}: a posterior of {post.dtype}, finite "
                             f"{bool(torch.isfinite(post).all())}")
    return (post.mean(0).double().cpu().numpy(), post.std(0).double().cpu().numpy(), counts,
            float(state.minimization_state.fun), secs)


def acceptance_check(truth, m64, s64, m32):
    """`tests/test_f32_acceptance.py`'s criteria: the float32 posterior
    mean `m32` recovers `truth` with an rms error at most 1.1 times the
    float64 one's (`m64`), and lies within the mean float64 posterior std
    (`s64`) of `m64` everywhere.  Returns the numbers; raises, with them,
    where a criterion fails."""
    rms64 = float(np.sqrt(((m64 - truth) ** 2).mean()))
    rms32 = float(np.sqrt(((m32 - truth) ** 2).mean()))
    sigma = float(s64.mean())
    max_delta = float(np.abs(m32 - m64).max())
    got = dict(rms32=rms32, rms64=rms64, ratio=rms32 / rms64, max_delta=max_delta, sigma=sigma)
    if not (rms32 <= 1.1 * rms64 and max_delta <= sigma):
        raise AssertionError(f"f32 acceptance fails (rms ratio at most 1.1, max delta at most "
                             f"sigma): {got}")
    return got


@phase("43 float32: phases 5 and 6 with enable_x64 off, both in the mixed mode, and the port "
       "of tests/test_f32_acceptance.py (64^2, 4 iterations of 2 pairs)")
def phase_float32(jt, cells, smi_line):
    """`cells`: {label: (float64 likelihood, dims, n_bins, updates, maps,
    phase 5's or 6's KL energy and working memory)}.  The float32 runs
    start from phase 5's or 6's position and noise, rounded (`WideKey`).
    A run's working memory is its peak allocation above what was allocated
    when it started (the models and data of every phase are on the card
    then).  Returns the launch counts of each run, by run name."""
    out = {}
    jt.config.update("enable_x64", False)
    try:
        for label, (lh, dims, n_bins, n, maps, (energy64, peak64)) in cells.items():
            cf = build_field(jt, dims, n_bins)
            # phase 5's or 6's data (float64), narrowed by the likelihood
            lh32 = jt.Gaussian(lh.likelihood.data,
                               noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf)
            with torch.no_grad():
                start_gap = max(float((a.double() - b.float().double()).abs().max()) for a, b in zip(
                    jt.tree.tree_leaves(jt.random_like(WideKey(jt, 1), lh32.domain)),
                    jt.tree.tree_leaves(jt.random_like(1, lh.domain))))
            if start_gap != 0.0:
                raise AssertionError(f"{label} float32: the start is not phase 5's or 6's "
                                     f"rounded (max difference {start_gap})")
            base = torch.cuda.memory_allocated()
            counts, energy, samples = drive(jt, f"{label} float32", lh32, n,
                                            key=WideKey(jt, 7), pos_key=WideKey(jt, 1), **maps)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            leaves = jt.tree.tree_leaves((samples.pos, samples._samples))
            if {x.dtype for x in leaves} != {torch.float32}:
                raise AssertionError(f"{label} float32: samples of {({x.dtype for x in leaves})}")
            require_dtype(f"{label} float32", counts, "f32")
            print(f"{label} float32, from float64's start and noise rounded: KL energy "
                  f"{energy!r}, float64 (phase 5 / 6) {energy64!r}: relative "
                  f"{(energy - energy64) / abs(energy64):+.5f} | working memory {peak:.3f} GiB "
                  f"against float64's {peak64:.3f} GiB ({peak / peak64:.3f}) | distributor calls "
                  f"by dtype {dtype_text(counts)} | {smi_line}", flush=True)
            out[f"float32 {label}"] = counts
            del cf, lh32, samples
            torch.cuda.empty_cache()
    finally:
        jt.config.update("enable_x64", True)
    jt.config.update("transform_compute_dtype", "float32")
    try:
        for label, (lh, dims, n_bins, n, maps, (energy64, peak64)) in cells.items():
            base = torch.cuda.memory_allocated()
            counts, energy, _ = drive(jt, f"{label} mixed", lh, n, **maps)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            require_dtype(f"{label} mixed", counts, "f64")
            print(f"{label} mixed (float64 state, float32 transforms): KL energy {energy!r}, "
                  f"relative to float64's {(energy - energy64) / abs(energy64):+.5f} | working "
                  f"memory {peak:.3f} GiB ({peak / peak64:.3f} of float64's) | distributor calls by "
                  f"dtype {dtype_text(counts)} | {smi_line}", flush=True)
            out[f"mixed {label}"] = counts
            torch.cuda.empty_cache()
    finally:
        jt.config.update("transform_compute_dtype", None)
    store = {}
    try:
        m64, s64, c64, e64, t64 = acceptance_run(jt, True, store)
        m32, _, c32, e32, t32 = acceptance_run(jt, False, store)
    finally:
        jt.config.update("enable_x64", True)
    require_launches("acceptance float64", c64)
    require_launches("acceptance float32", c32)
    require_dtype("acceptance float64", c64, "f64")
    require_dtype("acceptance float32", c32, "f32")
    acc = acceptance_check(store["truth"], m64, s64, m32)
    print(f"f32 acceptance (64^2, 4 iterations of 2 pairs): float64 {t64:.3f} s, KL energy "
          f"{e64!r}; float32 {t32:.3f} s, KL energy {e32!r} | rms error of the posterior mean "
          f"float32 {acc['rms32']:.6e} float64 {acc['rms64']:.6e} (ratio {acc['ratio']:.4f}, at "
          f"most 1.1) | max |m32 - m64| {acc['max_delta']:.6e} = "
          f"{acc['max_delta'] / acc['sigma']:.4f} of the mean float64 posterior std "
          f"{acc['sigma']:.6e} (at most 1) | distributor calls by dtype float64 run "
          f"{dtype_text(c64)}, float32 run {dtype_text(c32)} | {smi_line}", flush=True)
    out["acceptance float64"], out["acceptance float32"] = c64, c32
    return out


# -- float32 for the remaining families (phase 46) --------------------------


def reference(energy, base, seconds):
    """What a float32 leg is held to: the float64 run's KL energy, its
    working memory (the peak allocation above `base`, what was allocated
    when the run started, in GiB) and its seconds."""
    return dict(energy=energy, peak=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                seconds=seconds)


def kernel_wrappers():
    """Every kernel wrapper of the port, by the name its launches print
    under."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops import hp_longitude as hl
    from nifty_tpu_torch.ops import icr_refine as ir
    from nifty_tpu_torch.ops import los_interp as li
    from nifty_tpu_torch.ops import nufft_window as nw

    return {"bin_gather": bg.bin_gather, "bin_segment_sum": bg.bin_segment_sum,
            "icr_refine": ir.icr_refine, "icr_refine_transpose": ir.icr_refine_transpose,
            "hp_longitude": hl.hp_longitude, "hp_longitude_adjoint": hl.hp_longitude_adjoint,
            "los_integrate": li.los_integrate, "los_integrate_adjoint": li.los_integrate_adjoint,
            "los_slab_forward": li.slab_row_partials, "nufft_interp": nw.window_interp,
            "nufft_spread": nw.window_spread, "nufft_factors": nw.build_factors}


def reset_all_counts():
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops import hp_longitude as hl
    from nifty_tpu_torch.ops import icr_refine as ir

    reset_counts()
    for mod in (bg, hl, ir):
        mod.reset_launch_counts()


def launches_by_dtype():
    """Every wrapper's kernel-route calls by float type ("f32" / "f64")."""
    return {name: dict(fn.launches_by_dtype) for name, fn in kernel_wrappers().items()}


def shape_counts():
    """Every wrapper's calls by shape, as the kernel phases' entries read
    them."""
    from nifty_tpu_torch.ops import bin_gather as bg

    return dict(dist=launch_counts(bg), icr=icr_counts(), hp=hp_counts(), los=los_counts(),
                k7=k7_counts())


def by_dtype_text(counts):
    return ", ".join(f"{name} {c}" for name, c in counts.items() if c)


def require_float32_kernels(label, counts, family):
    """Each wrapper of `family` launched its float32 entry, and no wrapper
    its float64 entry."""
    f64 = {name: c["f64"] for name, c in counts.items() if c.get("f64")}
    if f64:
        raise AssertionError(f"{label}: float64 kernel entries launched in a float32 run: {f64}")
    idle = [name for name in family if counts[name].get("f32", 0) <= 0]
    if idle:
        raise AssertionError(f"{label}: the float32 entries of {idle} never launched: {counts}")


#: phase 46's gate, phase 43's yardstick: a float32 update's KL energy within
#: 2 % of float64's from the same start, rounded
FLOAT32_ENERGY_RTOL = 0.02
#: the legs whose energy is reported beside float64's and not gated, and
#: why: on their metrics float32 CG departs from float64 in the JAX package
#: as in the port (measured on a CPU, PERF.md, PR 22), so a float32 update's
#: KL stage stops elsewhere; their sample stages agree
FLOAT32_ENERGY_REPORTED = {
    "HEALPix sky nside 256": (
        "float32 CG departs from float64 on this metric in both packages (the JAX package's "
        "HEALPix field, lmax 63: 39 % of the solution after 10 CG steps, 120 % after 40)"),
    "radio 1024^2": (
        "float32 CG departs from float64 on this metric in both packages (the JAX package's "
        "radio model, 128^2: 8.6 % of the solution after 10 CG steps, 371 % after 30)"),
}


def float32_leg(jt, label, make, ref, family, smi_line):
    """One float32 `OptimizeVI.update` of a family at its float64 phase's
    full width.  `make()`, called with `enable_x64` off, returns the float32
    likelihood, its optimizer, state and samples: the float64 phase's
    start and noise, rounded (`WideKey`).  Prints s/update, the KL energy
    beside `ref`'s (the float64 run's, :func:`reference`), the working
    memory beside float64's and every wrapper's launches by dtype.  Fails
    unless the energy is finite and within `FLOAT32_ENERGY_RTOL` of
    float64's, each wrapper in `family` launched its float32 entry and no
    wrapper a float64 entry.  Returns the launch counts (by wrapper, by
    shape) and by dtype."""
    jt.config.update("enable_x64", False)
    try:
        t0 = time.perf_counter()
        lh, opt, state, samples = make()
        synchronize(jt)
        built = time.perf_counter() - t0
        reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        samples, state = opt.update(samples, state)
        synchronize(jt)
        seconds = time.perf_counter() - t0
    finally:
        jt.config.update("enable_x64", True)
    got = reference(float(state.minimization_state.fun), base, seconds)
    counts = launches_by_dtype()
    shapes = shape_counts()
    energy, e64 = got["energy"], ref["energy"]
    rel = (energy - e64) / abs(e64)
    leaves = {x.dtype for x in jt.tree.tree_leaves((samples.pos, samples._samples))}
    reported = FLOAT32_ENERGY_REPORTED.get(label)
    print(f"{label} float32, from float64's start and noise rounded: {seconds:.3f} s/update "
          f"(float64 {ref['seconds']:.3f}; model built in {built:.3f} s) | KL energy {energy!r}, "
          f"float64 {e64!r}: relative {rel:+.5f}"
          + (f" (reported, not gated: {reported})" if reported else "")
          + f" | last KL Newton steps {int(state.minimization_state.nit)} (status "
          f"{int(state.minimization_state.status)}), geoVI steps per "
          f"sample {state.sample_state.nit.tolist()} | working memory {got['peak']:.3f} GiB "
          f"against "
          f"float64's {ref['peak']:.3f} GiB ({got['peak'] / max(ref['peak'], 1e-9):.3f}) | kernel "
          f"calls by "
          f"dtype: {by_dtype_text(counts)} | {smi_line}", flush=True)
    if leaves != {torch.float32}:
        raise AssertionError(f"{label} float32: samples of {leaves}")
    if not (np.isfinite(energy) and (reported or abs(rel) < FLOAT32_ENERGY_RTOL)):
        raise AssertionError(f"{label} float32: KL energy {energy} not finite or not within "
                             f"{FLOAT32_ENERGY_RTOL:.0%} of float64's {e64}")
    require_float32_kernels(label, counts, family)
    return dict(shapes=shapes, by_dtype=counts, **got, rel=rel)


def icr_float32(jt, field):
    """A float32 twin of an ICR field without a second host precompute: the
    same chart and kernel, its matrices (built in float64 on the host, as
    the JAX package builds them too) rounded once into float32 levels of the
    same geometry (:func:`level_like`), and a float32 domain."""
    from functools import partial

    from nifty_tpu_torch.model import Initializer

    twin = copy.copy(field)
    twin._buffers = {k: v.to(torch.float32) if v is not None and v.is_floating_point() else v
                     for k, v in field._buffers.items()}
    twin._modules = dict(field._modules)
    twin._modules["levels"] = torch.nn.ModuleList(
        [level_like(lv, torch.float32) for lv in field.levels])
    domain = {k: jt.ShapeWithDtype(v.shape, torch.float32) for k, v in field.domain.items()}
    twin._domain = domain
    twin._init = Initializer({k: partial(jt.random_like, primals=v) for k, v in domain.items()})
    return twin


def float32_start(jt, lh, kwargs, key=7, pos_key=1, scale=None, **maps):
    """:func:`start` with the keys' float64 draws rounded (`WideKey`): an
    int key as phases 5-21 give it, or a `HostKey` pair; `scale` times the
    position where the float64 phase scales its start."""
    opt, samples, state = start(jt, lh, kwargs, WideKey(jt, key), WideKey(jt, pos_key), **maps)
    if scale is not None:
        samples = jt.Samples(pos={k: scale * v for k, v in samples.pos.items()}, samples=None,
                             keys=None)
    return lh, opt, state, samples


@phase("46 float32: phase 19's 4100^2 ICR update and phase 21's sphere x radius")
def phase_icr_float32(jt, cells, smi_line):
    """`cells`: {label: (ICR field, float64 likelihood, its noise std, the
    float64 run's reference, response)}: each field's float32 twin
    (:func:`icr_float32`) under the float64 run's data, rounded, observed
    by `response(field)`; one update (`BENCH_KWARGS`, the sample loop) from
    the float64 run's start and noise rounded."""
    out = {}
    for label, (field, lh64, noise_std, ref, response) in cells.items():
        def make():
            gp = icr_float32(jt, field)
            lh = jt.Gaussian(lh64.likelihood.data,
                             noise_cov_inv=lambda x: x / noise_std ** 2).amend(response(gp))
            return float32_start(jt, lh, BENCH_KWARGS, residual_map="smap", kl_map="smap")

        out[label] = float32_leg(jt, label, make, ref, ("icr_refine", "icr_refine_transpose"),
                                 smi_line)
        torch.cuda.empty_cache()
    return out


@phase("46 float32: phase 27's 256^3 tomography update")
def phase_tomography_float32(jt, lh64, los, noise_std, ref, smi_line):
    """Phase 27's model in float32: a float32 correlated field
    (`tomography_model`'s priors, `n_bins=128`) through phase 27's response
    itself (its float32 ray table built from the same rays, beside the
    float64 one), phase 27's data rounded; one update at `TOMO256_KWARGS`
    from phase 27's start and noise rounded."""
    def make():
        cf = tomography_field(jt, TOMO256_RAYS["dims"], n_bins=128)
        lh = jt.Gaussian(lh64.likelihood.data,
                         noise_cov_inv=lambda x: x / noise_std ** 2).amend(los_model(jt, cf, los))
        opt = jt.OptimizeVI(lh, n_total_iterations=3, residual_map="smap", kl_map="smap")
        state, pos = tomography_256_start(jt, opt, lh, wide=True)
        return lh, opt, state, jt.Samples(pos=pos, samples=None, keys=None)

    return float32_leg(jt, "256^3 tomography", make, ref,
                       ("los_integrate", "los_integrate_adjoint", "bin_gather",
                        "bin_segment_sum"), smi_line)


@phase("46 float32: phase 35's radio 1024^2 update")
def phase_radio_float32(jt, lh64, rr, std, ref, smi_line):
    """Phase 35's model in float32: a float32 1024^2 correlated field
    through phase 35's response itself (its float32 window tables built
    from the same visibilities, its phase screens rounded once), phase
    35's data rounded; one update (`BENCH_KWARGS`, the sample loop) from
    phase 35's start and noise rounded."""
    def make():
        cf = build_field(jt, tuple(rr.domain.shape))
        lh = jt.Gaussian(lh64.likelihood.data, noise_cov_inv=lambda x: x / std ** 2).amend(
            pointwise(jt, cf, lambda s: rr(torch.exp(s))))
        return float32_start(jt, lh, BENCH_KWARGS, *jt.HostKey(RADIO_SEED + 1).split(2),
                             scale=0.1, residual_map="smap", kl_map="smap")

    return float32_leg(jt, "radio 1024^2", make, ref,
                       ("nufft_interp", "nufft_spread", "nufft_factors", "bin_gather",
                        "bin_segment_sum"), smi_line)


def sphere_float32(jt, sky):
    """`build_sphere(jt, 511, "healpix")` in float32 without a second host
    precompute of its Legendre table: the float64 sky's table, rounded on
    the card (the JAX package also evaluates it in float64 on the host)."""
    from nifty_tpu_torch.ops import healpix_sht as hs

    evaluate = hs.normalized_legendre_table
    hs.normalized_legendre_table = lambda lmax, theta, mmax: np.zeros((0, 0, 0))
    try:
        sky32 = build_sphere(jt, sky.spherical_transform.sht.lmax, "healpix")
    finally:
        hs.normalized_legendre_table = evaluate
    sky32.spherical_transform.sht.lam = sky.spherical_transform.sht.lam.to(torch.float32)
    return sky32


@phase("46 float32: phase 23's HEALPix sky (nside 256, lmax 511), its first update")
def phase_sphere_float32(jt, sky, lh64, k_init, k_opt, ref, smi_line):
    """Phase 23's model in float32 (:func:`sphere_float32`), phase 23's data
    rounded; the first update of its `optimize_kl` (4 pairs, the demo's
    budgets, the sample loop) from phase 23's start and noise rounded."""
    def make():
        sky32 = sphere_float32(jt, sky)
        noise_std_inv2 = lh64.likelihood.noise_cov_inv(torch.ones_like(lh64.likelihood.data))
        lh = jt.Gaussian(lh64.likelihood.data,
                         noise_cov_inv=lambda x: x * noise_std_inv2.to(x.dtype)).amend(sky32)
        opt = jt.OptimizeVI(lh, n_total_iterations=4, residual_map="smap", kl_map="smap")
        state = opt.init_state(WideKey(jt, k_opt), n_samples=4, **DEMO16_KWARGS)
        pos = {k: 0.1 * v for k, v in lh.init(WideKey(jt, k_init)).items()}
        return lh, opt, state, jt.Samples(pos=pos, samples=None, keys=None)

    return float32_leg(jt, "HEALPix sky nside 256", make, ref,
                       ("hp_longitude", "hp_longitude_adjoint", "bin_gather", "bin_segment_sum"),
                       smi_line)


def mean_potential(ham, chain):
    """The potential averaged over the kept half of a chain's samples (the
    cross-check's half), as a float."""
    keep = range(NUTS_TRANSITIONS // 2, NUTS_TRANSITIONS)
    with torch.no_grad():
        return float(sum(float(ham({k: v[i] for k, v in chain.samples.items()}))
                         for i in keep) / len(keep))


@phase("46 float32: phase 28's 16^3 NUTS chain")
def phase_nuts_float32(jt, lh64, los, noise_std, start, ref, smi_line):
    """Phase 28's chain in float32: a float32 correlated field through phase
    28's response (its float32 ray table), phase 28's data rounded; the
    same `NUTS_TRANSITIONS` transitions (step 0.02, depth 8, seed 42) from
    phase 28's geoVI position rounded.  Prints s/transition, the mean
    potential of the kept half beside float64's, the working memory and the
    launches by dtype; gates as :func:`float32_leg` (the potential for the
    KL energy) and on phase 28's cross-check against phase 28's geoVI
    posterior."""
    pos64, geo_mean, geo_std = start
    jt.config.update("enable_x64", False)
    try:
        t0 = time.perf_counter()
        cf = tomography_field(jt, (16,) * 3)
        lh = jt.Gaussian(lh64.likelihood.data,
                         noise_cov_inv=lambda x: x / noise_std ** 2).amend(los_model(jt, cf, los))
        pos = {k: v.to(torch.float32) for k, v in pos64.items()}

        def ham(x):
            return lh(x) + 0.5 * jt.vdot(x, x)

        chain = jt.NUTSChain(potential_energy=ham, inverse_mass_matrix=1.0, position_proto=pos,
                             step_size=0.02, max_tree_depth=8)
        built = time.perf_counter() - t0
        reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        synchronize(jt)
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        nuts, _ = chain.generate_n_samples(42, pos, NUTS_TRANSITIONS)
        synchronize(jt)
        seconds = time.perf_counter() - t0
        got = reference(mean_potential(ham, nuts), base, seconds)
        keep = range(NUTS_TRANSITIONS // 2, NUTS_TRANSITIONS)
        with torch.no_grad():
            cf_nuts = torch.stack([cf({k: v[i] for k, v in nuts.samples.items()})
                                   for i in keep]).double()
    finally:
        jt.config.update("enable_x64", True)
    counts, shapes = launches_by_dtype(), shape_counts()
    spread = geo_std + cf_nuts.std(0, correction=0) + 1e-3
    frac_off = float(((geo_mean - cf_nuts.mean(0)).abs() > 3.0 * spread).double().mean())
    energy, e64 = got["energy"], ref["energy"]
    rel = (energy - e64) / abs(e64)
    leaves = int((2 ** nuts.depths - 1).sum())
    print(f"16^3 NUTS float32, from phase 28's geoVI position rounded: {NUTS_TRANSITIONS} "
          f"transitions in {seconds:.3f} s ({seconds / NUTS_TRANSITIONS:.4f} s/transition, "
          f"float64 {ref['seconds'] / NUTS_TRANSITIONS:.4f}; {leaves} leapfrog leaves; model "
          f"built in {built:.3f} s) | mean potential of the kept half {energy!r}, float64 "
          f"{e64!r}: relative {rel:+.5f} | mean depth {float(nuts.depths.double().mean()):.3f} | "
          f"acceptance {float(nuts.acceptance.mean()):.4f} | divergences "
          f"{int(nuts.divergences.sum())} | voxels off phase 28's geoVI {frac_off:.4f} | "
          f"working memory {got['peak']:.3f} GiB against float64's {ref['peak']:.3f} GiB | "
          f"kernel calls by dtype: {by_dtype_text(counts)} | {smi_line}", flush=True)
    if {x.dtype for x in jt.tree.tree_leaves(nuts.samples)} != {torch.float32}:
        raise AssertionError("16^3 NUTS float32: samples not float32")
    if not (np.isfinite(energy) and abs(rel) < FLOAT32_ENERGY_RTOL):
        raise AssertionError(f"16^3 NUTS float32: mean potential {energy} not finite or not "
                             f"within {FLOAT32_ENERGY_RTOL:.0%} of float64's {e64}")
    if not frac_off < 0.05:
        raise AssertionError(f"float32 NUTS and geoVI disagree on {frac_off:.4f} of the voxels")
    require_float32_kernels("16^3 NUTS", counts, ("los_integrate", "los_integrate_adjoint",
                                                  "bin_gather", "bin_segment_sum"))
    return dict(shapes=shapes, by_dtype=counts, **got, rel=rel)


def present(name):
    """Whether the optional host library `name` (h5py for the HDF5 export,
    matplotlib for the figures) is installed.  The legs that need a missing
    one are not run; nothing on the device or kernel path needs either.
    Where one is present, an exception from it fails the run."""
    import importlib.util

    return importlib.util.find_spec(name) is not None


def optional_libraries():
    """Print `<name>: present (version)` or `<name>: absent` for h5py and
    matplotlib; matplotlib draws with Agg."""
    import importlib

    for name in ("h5py", "matplotlib"):
        if not present(name):
            print(f"{name}: absent", flush=True)
            continue
        mod = importlib.import_module(name)
        print(f"{name}: present ({mod.__version__})", flush=True)
        if name == "matplotlib":
            mod.use("Agg")


def write_figures(label, draw):
    """`draw(directory)` draws a demo's figures into a temporary directory
    and returns their paths (and those of figures already drawn
    elsewhere); prints each file's size.  Not run where matplotlib is
    absent."""
    if not present("matplotlib"):
        print(f"{label} figures: not drawn (matplotlib: absent)", flush=True)
        return
    with tempfile.TemporaryDirectory() as d:
        paths = draw(d)
        sizes = {os.path.basename(f): os.path.getsize(f) for f in paths}
    print(f"{label} figures: " + ", ".join(f"{k} {v} bytes" for k, v in sizes.items()),
          flush=True)
    if min(sizes.values()) <= 1000:
        raise AssertionError(f"{label}: a figure is nearly empty: {sizes}")


def summary_figure(jt, d, name, panels, **kw):
    """`Plot.output` of `panels` ((array, title) pairs) into `d/name`."""
    p = jt.Plot()
    for arr, title in panels:
        p.add(arr, title=title)
    path = os.path.join(d, name)
    p.output(name=path, **kw)
    return path


def demo0_problem(jt):
    """`demos/0_intro.py`'s model and data at 128^2 and its `optimize_kl`
    budgets: `(signal, lh, truth, data, k_init, k_opt, budgets)`."""
    signal = pointwise(jt, build_field(jt, (128, 128), offset_mean=2.0), torch.exp)
    k_truth, k_noise, k_init, k_opt = jt.split(42, 4)
    with torch.no_grad():
        truth = signal(signal.init(k_truth))
        data = truth + 0.1 * jt.random_like(k_noise, truth)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: 0.1 ** -2 * x).amend(signal)
    delta, n_samples = 1e-4, 4
    size = jt.tree.size(lh.domain)
    budgets = dict(
        n_samples=lambda i: n_samples // 2 if i < 2 else n_samples,
        draw_linear_kwargs=dict(cg_kwargs=dict(absdelta=delta * size / 10.0, maxiter=100)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(xtol=delta, maxiter=5)),
        kl_kwargs=dict(minimize_kwargs=dict(absdelta=delta * size, maxiter=25)),
        sample_mode=lambda i: "nonlinear_resample" if i >= 2 else "linear_resample")
    return signal, lh, truth, data, k_init, k_opt, budgets


@phase("9 optimize_kl with odir, 3 iterations, resume for a 4th")
def phase_optimize_kl(jt):
    """`demos/0_intro.py`'s model and `optimize_kl` call at 128^2, with the
    demo's figures (its summary and the energy history).  Returns the
    launch counts and the KL energy after 3 iterations."""
    from nifty_tpu_torch.ops import bin_gather as bg

    signal, lh, truth, data, k_init, k_opt, budgets = demo0_problem(jt)

    def run(position_or_samples, n_total, odir, **kw):
        return jt.optimize_kl(lh, position_or_samples, key=k_opt, n_total_iterations=n_total,
                              odir=odir, **budgets, **kw)

    with tempfile.TemporaryDirectory() as odir:
        bg.reset_launch_counts()
        marks = [time.perf_counter()]

        def clock(samples, state):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        samples3, state3 = run(jt.random_like(k_init, lh.domain), 3, odir, callback=clock)
        counts = launch_counts(bg)
        files = sorted(os.listdir(odir))
        # the fourth iteration continued in memory ...
        ram_dir = os.path.join(odir, "in_memory")
        samples_m, state_m = run(samples3, 4, ram_dir, _optimize_vi_state=state3)
        # ... and resumed from the checkpoint the third iteration wrote
        samples_r, state_r = run(None, 4, odir, resume=True)
        with open(os.path.join(odir, "minisanity.txt")) as f:
            report = f.read()

        def figures(d):
            with torch.no_grad():
                mean, std = jt.mean_and_std([signal(s) for s in samples_r])
            return [summary_figure(jt, d, "summary.png", [
                (truth, "truth"), (data, "data"), (mean, "posterior mean"),
                (std, "posterior std")]), os.path.join(odir, "energy_history.png")]

        write_figures("demo 0", figures)
    # the JAX package's default `plot_energy_history=True` draws the energy
    # history where matplotlib imports
    want = (["energy_history.png"] if present("matplotlib") else []) + [
        "last.pkl", "minisanity.txt"]
    if files != want:
        raise AssertionError(f"optimize_kl wrote {files}, not {want}")
    if not (state_m.nit == state_r.nit == 4):
        raise AssertionError(f"iteration counters {state_m.nit}, {state_r.nit}")
    same = float(state_m.minimization_state.fun) == float(state_r.minimization_state.fun)
    for k in samples_m.pos:
        same &= torch.equal(samples_m.pos[k], samples_r.pos[k])
        same &= torch.equal(samples_m._samples[k], samples_r._samples[k])
    seconds = [b - a for a, b in zip(marks, marks[1:])]
    energy3 = float(state3.minimization_state.fun)
    print(f"optimize_kl: s/iteration {[round(s, 3) for s in seconds]} | KL energy after 3 "
          f"{energy3!r}, after 4 "
          f"{float(state_r.minimization_state.fun)!r} | resumed 4th iteration bitwise equal "
          f"to the one continued in memory: {bool(same)} | launches in 3 iterations gather "
          f"{counts['gather']} segment_sum {counts['segsum']}, by rows of the table: "
          f"{rows_text(counts)}", flush=True)
    print(report[report.rindex("OPTIMIZE_KL: iter"):], flush=True)
    if not same:
        raise AssertionError("the resumed 4th iteration differs from the uninterrupted one")
    if report.count("OPTIMIZE_KL: iter") != 4:
        raise AssertionError("minisanity.txt does not hold one report per iteration")
    require_launches("optimize_kl", counts)
    return counts, energy3


def run_optimize_kl(jt, label, lh, position, maps=(), **kwargs):
    """`optimize_kl(lh, position, **kwargs)` with the launch counts and the
    peak memory reset just before and a clock after every iteration: prints
    s/iteration, the KL energy, peak memory and the launches by rows and by
    map; fails unless both kernels launched (on each of `maps`)."""
    from nifty_tpu_torch.ops import bin_gather as bg

    torch.cuda.reset_peak_memory_stats()
    bg.reset_launch_counts()
    marks = [time.perf_counter()]

    def clock(samples, state):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    samples, state = jt.optimize_kl(lh, position, callback=clock, **kwargs)
    counts = launch_counts(bg)
    energy = float(state.minimization_state.fun)
    seconds = [b - a for a, b in zip(marks, marks[1:])]
    print(f"{label}: s/iteration {[round(s, 3) for s in seconds]} ({sum(seconds):.3f} s) | KL "
          f"energy {energy!r} | peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"launches gather {counts['gather']} segment_sum {counts['segsum']}, by rows of the "
          f"table: {rows_text(counts)} | by map: {maps_text(counts)}", flush=True)
    if not np.isfinite(energy):
        raise AssertionError(f"{label}: non-finite KL energy {energy}")
    require_launches(label, counts, maps)
    return samples, state, counts


@phase("11 optimize_kl as demos/10_multifrequency.py, 64 x 16, 5 iterations")
def phase_multifrequency(jt):
    """`demos/10_multifrequency.py`'s model, data and `optimize_kl` call:
    the posterior mean must be closer to the truth than the noise level.
    Draws the demo's `Plot` figure (the frequencies as RGB, the posterior's
    mean and std) and its energy history."""
    noise_std = 0.2
    cf = build_multifrequency(jt, (64,), 16)
    k_truth, k_noise, k_init, k_opt = jt.HostKey(5).split(4)
    with torch.no_grad():
        truth = cf(cf.init(k_truth))
        data = truth + noise_std * jt.random_like(k_noise, truth)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std ** 2).amend(cf)
    with tempfile.TemporaryDirectory() as odir:
        samples, state, counts = run_optimize_kl(
            jt, "multifrequency optimize_kl", lh, jt.random_like(k_init, lh.domain), cf.dists,
            key=k_opt, n_total_iterations=5, n_samples=4,
            draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=64)),
            nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
                xtol=1e-3, maxiter=5, cg_kwargs=dict(maxiter=24))),
            kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=12, cg_kwargs=dict(maxiter=32))),
            sample_mode="nonlinear_resample", odir=odir)
        with torch.no_grad():
            post = cf(samples.samples)

        def figures(d):
            def as_cube(img):
                # (space, freq) -> (freq, strip height, space), a false-colour strip
                return np.repeat(img.cpu().numpy().T[:, None, :], 8, axis=1)

            p = jt.Plot()
            p.add(as_cube(torch.exp(truth)), freqs_as_rgb=True, title="truth (RGB)")
            p.add(as_cube(torch.exp(post.mean(0))), freqs_as_rgb=True,
                  title="posterior mean (RGB)")
            p.add_uncertainty(post, title="posterior")
            path = os.path.join(d, "rgb_and_uncertainty.png")
            p.output(name=path, xsize=10, ysize=8)
            return [path, os.path.join(odir, "energy_history.png")]

        write_figures("demo 10", figures)
    rms = float(torch.sqrt(torch.mean((post.mean(0) - truth) ** 2)))
    print(f"multifrequency optimize_kl: posterior rms error {rms:.4f} (noise level {noise_std}) | "
          f"{len(samples)} samples", flush=True)
    if not rms < noise_std:
        raise AssertionError(f"posterior rms error {rms} is not below the noise level {noise_std}")
    return counts


@phase("13 optimize_kl as demos/2_poisson_counts.py, 128^2, 5 iterations")
def phase_poisson_counts(jt):
    """`demos/2_poisson_counts.py`: Poisson counts of a log-normal field,
    geoVI with the Poissonian's metric square roots, lockstep (`"auto"`).
    The posterior mean of the rates must be closer to the true rates than
    the counts are.  Draws the demo's `Plot` summary."""
    k_truth, k_init, k_opt = jt.HostKey(42).split(3)
    lh, truth, counts = poisson_likelihood(
        jt, build_poisson_demo_field(jt, (128, 128)), k_truth, seed=42)
    samples, state, launches = run_optimize_kl(
        jt, "poisson counts optimize_kl", lh, jt.random_like(k_init, lh.domain), key=k_opt,
        n_total_iterations=5, n_samples=4,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=80)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(xtol=1e-3, maxiter=4)),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=20)),
        sample_mode="nonlinear_resample")
    with torch.no_grad():
        rates = lh.model(samples.samples)
        rate_mean = rates.mean(0)
    counts = torch.from_numpy(counts).to(truth)
    write_figures("demo 2", lambda d: [summary_figure(jt, d, "summary.png", [
        (truth, "truth"), (counts, "counts"), (rate_mean, "posterior mean"),
        (rates.std(0), "posterior std")])])
    rms_post = float(torch.sqrt(torch.mean((rate_mean - truth) ** 2)))
    rms_counts = float(torch.sqrt(torch.mean((counts - truth) ** 2)))
    _, table = jt.minisanity(samples, lh.normalized_residual)
    print(f"poisson counts: posterior mean rate rms error {rms_post:.4f} against the counts' "
          f"{rms_counts:.4f} | mean rate {float(truth.mean()):.3f} | {len(samples)} samples | "
          f"data residual:\n{table}", flush=True)
    if not rms_post < rms_counts:
        raise AssertionError(
            f"the posterior mean (rms {rms_post}) is not closer to the rates than the counts "
            f"({rms_counts})")
    return launches


@phase("14 demos/14_bernoulli_map.py: MAP, then geoVI, 128^2")
def phase_bernoulli(jt, seed=BERNOULLI_SEED):
    """`demos/14_bernoulli_map.py`: one Bernoulli event a pixel on a
    sigmoid of a correlated field; 12 MAP iterations (`n_samples=0`), then 4
    geoVI iterations from the MAP.  The demo's check: the posterior mean's
    mean |p - truth| below 0.25 and the truth within 2 posterior std on
    more than 90 % of the pixels."""
    eps = 1e-4
    prob = pointwise(jt, build_bernoulli_demo_field(jt, (128, 128)),
                     lambda s: eps + (1.0 - 2 * eps) * torch.sigmoid(s))
    k_truth, k_init, k_map, k_vi = jt.HostKey(seed).split(4)
    with torch.no_grad():
        truth = prob(prob.init(k_truth))
    events = np.random.default_rng(seed).uniform(size=tuple(truth.shape)) < truth.cpu().numpy()
    lh = jt.Bernoulli(torch.from_numpy(events.astype(np.int32)).to(truth.device)).amend(prob)
    map_samples, _, c_map = run_optimize_kl(
        jt, "bernoulli MAP", lh, jt.random_like(k_init, lh.domain), key=k_map,
        n_total_iterations=12, n_samples=0,
        kl_kwargs=dict(minimize_kwargs=dict(
            name="MAP", xtol=1e-6, maxiter=25, cg_kwargs=dict(maxiter=60))))
    vi_samples, _, c_vi = run_optimize_kl(
        jt, "bernoulli geoVI", lh, map_samples.pos, key=k_vi, n_total_iterations=4, n_samples=4,
        draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=50)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-3, maxiter=5, cg_kwargs=dict(maxiter=20))),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=10, cg_kwargs=dict(maxiter=30))),
        sample_mode="nonlinear_resample")
    with torch.no_grad():
        p_map = prob(map_samples.pos)
        p = prob(vi_samples.samples)
    p_mean, p_std = p.mean(0), p.std(0)
    err_map = float((p_map - truth).abs().mean())
    err_vi = float((p_mean - truth).abs().mean())
    cover = float(((p_mean - truth).abs() <= 2.0 * p_std).double().mean())
    acc = float(((p_mean > 0.5) == (truth > 0.5)).double().mean())
    print(f"bernoulli: MAP mean |p - truth| {err_map:.4f} | geoVI mean |p - truth| {err_vi:.4f}, "
          f"2-sigma coverage {cover:.3f}, decision accuracy {acc:.3f}", flush=True)
    if not (err_vi < 0.25 and cover > 0.9):
        raise AssertionError(f"the posterior failed to recover the field: mean |p - truth| "
                             f"{err_vi}, coverage {cover}")
    return c_map, c_vi


@phase("16 demos/6_density_estimation.py, 128 bins, 6 iterations")
def phase_density(jt):
    """`demos/6_density_estimation.py`: Poisson counts of 1500 events in 128
    bins, the rate `density_estimator(128, 1/128)` (a Matern field on the
    padded 256-entry grid); the demo's checks: predicted events within 25 %
    of those observed, and the two modes found."""
    counts = density_counts()
    model, _ = jt.density_estimator(128, 1.0 / 128)
    lh = jt.Poissonian(torch.from_numpy(counts).to(jt.config.default_device())).amend(model)
    k_init, k_opt = jt.HostKey(3).split(2)
    samples, _, launches = run_optimize_kl(
        jt, "density estimation optimize_kl", lh, jt.Vector(lh.init(k_init)), (model.field.dist,),
        key=k_opt, n_total_iterations=6, n_samples=2,
        draw_linear_kwargs=dict(cg_kwargs=dict(absdelta=1e-4, maxiter=50)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=5)),
        kl_kwargs=dict(minimize_kwargs=dict(absdelta=1e-4, maxiter=20)))
    with torch.no_grad():
        rate_mean = model(samples.samples).mean(0).cpu().numpy()
    predicted, observed = float(rate_mean.sum()), float(counts.sum())
    third = 128 // 3
    modes = float(rate_mean[:third].max()) > float(rate_mean[third:2 * third].min())
    print(f"density estimation: predicted events {predicted:.1f} against {observed:.0f} observed "
          f"| rate at the modes 0.3 / 0.7: {rate_mean[38]:.2f} / {rate_mean[89]:.2f}, between "
          f"them (0.5) {rate_mean[64]:.2f} | {len(samples)} samples", flush=True)
    if not abs(predicted - observed) < 0.25 * observed:
        raise AssertionError(f"predicted events {predicted} are not within 25 % of {observed}")
    if not modes:
        raise AssertionError("the density estimate does not show the two modes")
    return launches


# -- iterative charted refinement (phases 17-21) ------------------------------

ICR_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# phase 18: `demos/9_icr_refinement.py`'s seeds (the truth, the mask) and
# noise level
DEMO9_SEED, DEMO9_MASK_SEED, DEMO9_NOISE = 33, 11, 0.05


def level_like(level, dtype=None, olf=None, ker=None, matrix_grid=None):
    """A refinement level of `level`'s geometry on its device, with its
    matrices in `dtype` or the matrices given."""
    from nifty_tpu_torch.ops.icr_refine import RefineLevel

    dtype = dtype or level.olf.dtype
    olf = level.olf if olf is None else olf
    ker = level.ker if ker is None else ker
    grid = level.matrix_grid if matrix_grid is None else matrix_grid
    windows = [getattr(level, f"window{a}").cpu().numpy() for a in range(level.ndim)]
    return RefineLevel(level.coarse_shape, windows, level.child_shape, olf.to("cpu", dtype),
                       ker.to("cpu", dtype), grid).to(level.olf.device)


def conv_route(level):
    """For a 2-D level of 3 x 3 windows at stride 1 and 2 x 2 children: the
    level on an undeformed chart of its shape (its first matrix pair shared
    by every site) and the library's routes for it.  The step: `conv2d` of
    the coarse grid with the filter plus a 1 x 1 `conv2d` of the excitations
    (given as channels) with `ker`, then `pixel_shuffle`.  The transpose:
    `pixel_unshuffle` of the cotangent, `conv_transpose2d` with the filter
    (the coarse cotangent) and a 1 x 1 `conv2d` with `ker` transposed (the
    excitations' cotangent, as channels).  None for another geometry."""
    if level.ndim != 2 or level.slots != (3, 3) or level.child_shape != (2, 2):
        return None
    for a in range(2):
        w = getattr(level, f"window{a}").cpu().numpy()
        if not np.array_equal(w, np.arange(w.shape[0])[:, None] + np.arange(3)[None, :]):
            return None
    shared = level_like(level, olf=level.olf[:1], ker=level.ker[:1], matrix_grid=(1, 1))
    fn = torch.nn.functional
    w_olf = shared.olf[0].reshape(4, 1, 3, 3)
    w_ker = shared.ker[0].reshape(4, 4, 1, 1)
    w_ker_t = w_ker.transpose(0, 1).contiguous()

    def route(coarse, xi_channels):
        nrows = coarse.shape[0]
        y = (fn.conv2d(coarse.reshape(nrows, 1, *level.coarse_shape), w_olf)
             + fn.conv2d(xi_channels, w_ker))
        return fn.pixel_shuffle(y, 2).reshape(nrows, -1)

    def route_t(cot):
        nrows = cot.shape[0]
        y = fn.pixel_unshuffle(cot.reshape(nrows, 1, *level.fine_shape), 2)
        return fn.conv_transpose2d(y, w_olf).reshape(nrows, -1), fn.conv2d(y, w_ker_t)

    return shared, route, route_t


def kernel_text(level, transpose):
    """Registers, spilled bytes and shared memory a block of each kernel a
    call on `level` launches."""
    from nifty_tpu_torch.ops import icr_refine as ir

    return " + ".join(f"{k['registers']} regs, {k['local_bytes']} B spilled, "
                      f"{k['static_smem'] + k['dynamic_smem']} B smem"
                      for k in ir.describe_kernels(level, transpose))


def icr_bound_ms(level, nrows, size, transpose):
    """The least time of a step (or its transpose) on the card: its inputs
    (values, matrices, window tables, for the transpose also their CSR
    inverses) read once and its outputs written once over the memory rate,
    or its multiply-adds over the arithmetic rate; and which of the two."""
    read = level.tables() if transpose else level.tables()[:level.ndim]
    tables = sum(t.numel() * t.element_size() for t in read)
    values = nrows * (level.n_coarse + level.S * level.F + level.n_fine) * size
    mats = (level.olf.numel() + level.ker.numel()) * size
    by_bytes = 1e3 * (values + mats + tables) / PEAK_BYTES_PER_S
    dtype = torch.float64 if size == 8 else torch.float32
    by_ops = 1e3 * 2 * nrows * level.S * level.F * (level.W + level.F) / PEAK_OPS_PER_S[dtype]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


@phase("17 the refinement kernels vs plain")
def phase_icr_kernels(cases, f32=()):
    """`cases`: {label: (RefineLevel on the card, rows)}.  Each step and its
    transpose against the plain versions in float64 and float32 (within
    1e-12 / 1e-5 of the plain output's largest entry), bitwise reproducible
    and bitwise equal when replayed from a CUDA graph; float64 device ms
    (the kernels: 50 calls in a replayed CUDA graph; the plain forward too;
    the plain transpose, an autograd pull-back, by CUDA events around 20
    calls) beside the bound, and, for a 2-D level of the 3 x 3 / 2 x 2
    stencil, the library route on an undeformed chart of the same shape
    (`conv2d` + `pixel_shuffle`; for the transpose `pixel_unshuffle` +
    `conv_transpose2d` + `conv2d`), held to the kernels on shared
    matrices.  The labels in `f32` (the shapes phase 46's float32 legs
    launch) are timed in float32 too, under `"<label> float32"`."""
    from nifty_tpu_torch.ops import icr_refine as ir

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    results = {}
    for label, (level, nrows) in cases.items():
        for dtype in (torch.float64, torch.float32):
            lv = level if dtype == level.olf.dtype else level_like(level, dtype)
            coarse = torch.randn((nrows, lv.n_coarse), dtype=dtype, device=dev, generator=gen)
            xi = torch.randn((nrows, lv.S * lv.F), dtype=dtype, device=dev, generator=gen)
            cot = torch.randn((nrows, lv.n_fine), dtype=dtype, device=dev, generator=gen)
            fine1, fine2 = ir.icr_refine(coarse, xi, lv), ir.icr_refine(coarse, xi, lv)
            back1, back2 = ir.icr_refine_transpose(cot, lv), ir.icr_refine_transpose(cot, lv)
            fine_p = ir.icr_refine_plain(coarse, xi, lv)
            back_p = ir.icr_refine_transpose_plain(cot, lv)
            torch.cuda.synchronize()
            if not (torch.equal(fine1, fine2) and all(map(torch.equal, back1, back2))):
                raise AssertionError(f"the refinement kernels do not repeat ({label}, {dtype})")
            if not (torch.equal(fine1, replayed(lambda: ir.icr_refine(coarse, xi, lv)))
                    and all(map(torch.equal, back1, replayed(
                        lambda: ir.icr_refine_transpose(cot, lv))))):
                raise AssertionError(
                    f"the refinement kernels differ when replayed from a CUDA graph ({label}, "
                    f"{dtype})")
            errs = [float((got - want).abs().max()) / float(want.abs().max())
                    for got, want in ((fine1, fine_p), (back1[0], back_p[0]),
                                      (back1[1], back_p[1]))]
            if max(errs) > ICR_RTOL[dtype]:
                raise AssertionError(f"the refinement kernels are off their plain versions by "
                                     f"{errs} of the largest entry ({label}, {dtype})")
            if dtype == torch.float32 and label not in f32:
                continue
            r = dict(refine_err=float((fine1 - fine_p).abs().max()),
                     transpose_err=max(float((back1[0] - back_p[0]).abs().max()),
                                       float((back1[1] - back_p[1]).abs().max())))
            r.update(icr_timings(ir, lv, coarse, xi, cot, nrows, dtype, label))
            results[label if dtype == torch.float64 else f"{label} float32"] = r
            lib, lib_t = r["refine_library_ms"], r["transpose_library_ms"]
            name = str(dtype).replace("torch.", "")
            print(
                f"{label}: coarse {lv.coarse_shape} -> fine {lv.fine_shape}, W {lv.W}, F {lv.F}, "
                f"{lv.n_matrices} matrix pairs, B={nrows}, routes {lv.step_route} / "
                f"{lv.transpose_route} | {name} device ms: step "
                f"{r['refine_device_ms']:.5f} ({r['refine_bound_ms'] / r['refine_device_ms']:.1%} "
                f"of the bound {r['refine_bound_ms']:.5f} by {r['refine_bound_by']}; plain "
                f"{r['refine_plain_device_ms']:.5f}"
                + (f", conv2d + pixel_shuffle {lib:.5f}" if lib is not None else "")
                + f"; {kernel_text(lv, False)}) | transpose {r['transpose_device_ms']:.5f} "
                f"({r['transpose_bound_ms'] / r['transpose_device_ms']:.1%} of the bound "
                f"{r['transpose_bound_ms']:.5f} by {r['transpose_bound_by']}; plain, events, "
                f"{r['transpose_plain_ms']:.5f}"
                + (f", pixel_unshuffle + conv_transpose2d + conv2d {lib_t:.5f}"
                   if lib_t is not None else "")
                + f"; {kernel_text(lv, True)}) | rel err float64 / float32 within "
                f"{ICR_RTOL[torch.float64]} / {ICR_RTOL[torch.float32]}; max abs err {name} "
                f"{r['refine_err']:.3e} / {r['transpose_err']:.3e}",
                flush=True,
            )
    return results


def icr_timings(ir, lv, coarse, xi, cot, nrows, dtype, label):
    """Phase 17's numbers of one level and dtype: the kernels' and the plain
    versions' ms, the bounds and the library routes where the level is the
    2-D stencil (held to the kernels first)."""
    r = dict(refine_device_ms=device_ms(lambda: ir.icr_refine(coarse, xi, lv)),
             transpose_device_ms=device_ms(lambda: ir.icr_refine_transpose(cot, lv)),
             refine_plain_device_ms=device_ms(lambda: ir.icr_refine_plain(coarse, xi, lv)),
             transpose_plain_ms=cuda_ms(lambda: ir.icr_refine_transpose_plain(cot, lv), n=20))
    size = coarse.element_size()
    r["refine_bound_ms"], r["refine_bound_by"] = icr_bound_ms(lv, nrows, size, False)
    r["transpose_bound_ms"], r["transpose_bound_by"] = icr_bound_ms(lv, nrows, size, True)
    r["refine_library_ms"] = r["transpose_library_ms"] = None
    library = conv_route(lv)
    if library is not None:
        shared, route, route_t = library
        xi_channels = xi.reshape(nrows, *lv.sites, lv.F).permute(0, 3, 1, 2).contiguous()
        want = ir.icr_refine(coarse, xi, shared)
        lib_err = float((route(coarse, xi_channels) - want).abs().max())
        want_c, want_x = ir.icr_refine_transpose(cot, shared)
        got_c, got_x = route_t(cot)
        got_x = got_x.permute(0, 2, 3, 1).reshape(nrows, -1)
        lib_err_t = max(float((got_c - want_c).abs().max()) / float(want_c.abs().max()),
                        float((got_x - want_x).abs().max()) / float(want_x.abs().max()))
        if lib_err > ICR_RTOL[dtype] * float(want.abs().max()) or lib_err_t > ICR_RTOL[dtype]:
            raise AssertionError(f"the conv2d routes are off the kernels by {lib_err} / "
                                 f"{lib_err_t} relative ({label}, {dtype})")
        r["refine_library_ms"] = device_ms(lambda: route(coarse, xi_channels))
        r["transpose_library_ms"] = device_ms(lambda: route_t(cot))
    return r


def icr_counts():
    """The refinement wrappers' calls of the kernel route, by (level key,
    rows)."""
    from nifty_tpu_torch.ops import icr_refine as ir

    return {"refine": dict(ir.icr_refine.launches_by_level),
            "transpose": dict(ir.icr_refine_transpose.launches_by_level)}


def require_icr_launches(label, counts, field):
    """Both refinement kernels launched at every level of `field`."""
    for kind in ("refine", "transpose"):
        for level in field.levels:
            if not any(key == level.key and n > 0 for (key, _), n in counts[kind].items()):
                raise AssertionError(
                    f"{label}: icr_{kind} never launched at the level {level.key}: {counts}")


def icr_text(counts, field):
    """Each level's calls of the two kernels by rows."""
    return "; ".join(
        f"L{lv} {level.fine_shape}: " + ", ".join(
            f"{kind} " + "/".join(f"B={b} {n}" for (key, b), n in sorted(counts[kind].items())
                                  if key == level.key)
            for kind in ("refine", "transpose"))
        for lv, level in enumerate(field.levels))


def drive_icr(jt, label, lh, field, n_updates=1, kwargs=BENCH_KWARGS, **maps):
    """`n_updates` updates of an ICR likelihood with the refinement launch
    counts and the peak memory reset just before; fails unless both kernels
    launched at every level.  Returns the counts and the run's
    :func:`reference` (what phase 46's float32 leg is held to)."""
    from nifty_tpu_torch.ops import icr_refine as ir

    torch.cuda.reset_peak_memory_stats()
    ir.reset_launch_counts()
    base = torch.cuda.memory_allocated()
    _, state, secs = run_updates(jt, lh, n_updates, kwargs, **maps)
    counts = icr_counts()
    energy = float(state.minimization_state.fun)
    med = sorted(secs)[len(secs) // 2]
    print(f"{label}: s/update {[round(s, 3) for s in secs]} | geoVI samples/s "
          f"{2 * N_SAMPLES / med:.4f} | KL energy {energy!r} | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | last KL Newton steps "
          f"{int(state.minimization_state.nit)}, geoVI steps per sample "
          f"{state.sample_state.nit.tolist()} | launches by level: {icr_text(counts, field)}",
          flush=True)
    if not np.isfinite(energy):
        raise AssertionError(f"{label}: non-finite KL energy {energy}")
    require_icr_launches(label, counts, field)
    return counts, reference(energy, base, secs[0])


def masked_signal(jt, field, npix, seed, fraction=3):
    """`demos/9_icr_refinement.py`'s signal exp(0.5 field) and response: the
    signal at a sorted random third of the final pixels (numpy, from
    `seed`)."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(npix, size=npix // fraction, replace=False))
    signal = pointwise(jt, field, lambda f: torch.exp(0.5 * f))
    flat = torch.from_numpy(idx).to(jt.config.default_device())
    response = pointwise(jt, field, lambda f: torch.exp(0.5 * f).flatten(-field.chart.ndim)[
        ..., flat])
    return signal, response


def icr_gaussian(jt, response, key, noise_seed, noise_std):
    """Data of `response` at latents drawn from `key`, with numpy noise of
    `noise_std` from `noise_seed`; returns the likelihood, the latents."""
    with torch.no_grad():
        truth_pos = response.init(key)
        clean = response(truth_pos)
    noise = np.random.default_rng(noise_seed).standard_normal(tuple(clean.shape))
    data = clean + noise_std * torch.from_numpy(noise).to(clean)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std ** 2).amend(response)
    return lh, truth_pos


@phase("18 demos/9_icr_refinement.py: optimize_kl on a log-deformed 1-D chart")
def phase_demo9(jt, gp):
    """The demo as written: chart (14,), depth 5, expm1(0.35 u), Matern-3/2;
    exp(0.5 gp) observed on a third of the pixels with noise 0.05; 6
    iterations of 4 pairs at the demo's budgets.  Its check: the truth
    within 3 (std + noise) of the posterior mean on at least 90 % of the
    pixels (a calibrated posterior leaves out about 0.3 %)."""
    from nifty_tpu_torch.ops import icr_refine as ir

    signal, response = masked_signal(jt, gp, gp.chart.shape[0], DEMO9_MASK_SEED)
    k_truth, k_init, k_opt = jt.HostKey(DEMO9_SEED).split(3)
    lh, truth_pos = icr_gaussian(jt, response, k_truth, DEMO9_SEED, DEMO9_NOISE)
    with torch.no_grad():
        truth = signal(truth_pos)
    torch.cuda.reset_peak_memory_stats()
    ir.reset_launch_counts()
    marks = [time.perf_counter()]

    def clock(samples, state):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    with tempfile.TemporaryDirectory() as odir:
        samples, state = jt.optimize_kl(
            lh, jt.random_like(k_init, lh.domain), key=k_opt, n_total_iterations=6,
            n_samples=4, callback=clock,
            draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=64)),
            nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
                xtol=1e-3, maxiter=5, cg_kwargs=dict(maxiter=24))),
            kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=12, cg_kwargs=dict(maxiter=32))),
            sample_mode="nonlinear_resample", odir=odir)
    counts = icr_counts()
    with torch.no_grad():
        post = signal(samples.samples)
    mean, std = post.mean(0), post.std(0, correction=0)
    inside = float(((mean - truth).abs() < 3 * (std + DEMO9_NOISE)).double().mean())
    seconds = [b - a for a, b in zip(marks, marks[1:])]
    energy = float(state.minimization_state.fun)
    print(f"demo 9 optimize_kl: s/iteration {[round(s, 3) for s in seconds]} ({sum(seconds):.3f} "
          f"s) | KL energy {energy!r} | posterior pixels within 3 sigma of the truth "
          f"{inside:.4f} | {len(samples)} samples | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | launches by level: "
          f"{icr_text(counts, gp)}", flush=True)
    if not np.isfinite(energy):
        raise AssertionError(f"demo 9: non-finite KL energy {energy}")
    require_icr_launches("demo 9", counts, gp)
    if not inside >= 0.9:
        raise AssertionError(f"demo 9: only {inside} of the pixels within 3 sigma of the truth")
    return counts


def chart_4100(jt):
    """Phase 19's chart: (20, 20) refined 8 times to 4100 x 4100, demo 9's
    log deformation on axis 0 rescaled to its 20 coarse pixels, axis 1
    regular."""
    def deform(reg):
        return np.stack([np.expm1(0.245 * reg[..., 0]), reg[..., 1]], axis=-1)

    return jt.CoordinateChart((20, 20), depth=8, distances0=1.0, nonlinear_map=deform,
                              irregular_axes=(0,))


def build_icr_fields(jt):
    """The fields of phases 18-21 (demo 9's, phase 19's 4100^2 chart, a
    HEALPix sphere from nside 4 to 256, sphere x radius from (48, 6) to
    (49152, 68)), each printed with its host precompute's seconds."""
    out = {}
    builders = {
        "demo9": lambda: jt.RefinementField(
            jt.CoordinateChart(shape0=(14,), depth=5, distances0=(1.0,),
                               nonlinear_map=lambda reg: np.expm1(0.35 * reg)), matern32()),
        "4100^2": lambda: jt.RefinementField(chart_4100(jt), matern32()),
        "sphere nside 256": lambda: jt.RefinementHPField(jt.HEALPixChart(4, depth=6),
                                                         matern32(0.5)),
        "sphere x radius": lambda: jt.RefinementHPField(jt.HEALPixChart(
            2, depth=5, radial_chart=jt.CoordinateChart(6, depth=5, distances0=0.5,
                                                        nonlinear_map=np.exp)), matern32()),
    }
    for name, build in builders.items():
        t0 = time.perf_counter()
        f = out[name] = build()
        synchronize(jt)
        seconds = time.perf_counter() - t0
        mats = sum(lv.olf.numel() + lv.ker.numel() for lv in f.levels) * 8
        print(f"ICR field {name}: levels {[lv.fine_shape for lv in f.levels]}, "
              f"{sum(v.size for v in f.domain.values())} latent dof, matrices "
              f"{mats / 2**20:.1f} MiB on the device, host precompute {seconds:.3f} s",
              flush=True)
    return out


@phase("19 a 4100^2 deformed chart: exp(0.5 gp) on a third of the pixels, 1 update")
def phase_4100(jt, gp, with_profile):
    """Demo 9's model on phase 19's chart (22.4 M latent dof): exp(0.5 gp)
    observed on a third of the 16.8 M pixels with noise 0.05, data from the
    prior; `BENCH_KWARGS` with the sample loop for both stages."""
    _, response = masked_signal(jt, gp, int(np.prod(gp.chart.shape)), DEMO9_MASK_SEED)
    lh, _ = icr_gaussian(jt, response, jt.HostKey(19), 19, DEMO9_NOISE)
    counts, ref = drive_icr(jt, "4100^2 deformed chart", lh, gp, residual_map="smap",
                            kl_map="smap")
    if with_profile:
        profile_update(jt, "4100^2 deformed chart", lh, residual_map="smap", kl_map="smap")
    return counts, lh, ref


def icr_kernel_entries(kres, paths, dtype="float64"):
    """The `kernels` line's entries of the two refinement kernels: one for
    each kernel, field level and number of rows that the runs in `paths`
    ({field name: (field, {run: counts})}) launched, with phase 17's numbers
    for that shape in `dtype`; fails on a shape that phase 17 did not
    check (time, for float32)."""
    src = "nifty_tpu_torch/csrc/icr_refine.cu"
    entries = []
    for name, (field, runs) in paths.items():
        replaces = ("nifty_tpu/refine/charted_field.py:283" if hasattr(field.chart, "coarse_size")
                    else "nifty_tpu/refine/healpix_field.py:190")
        for lv, level in enumerate(field.levels):
            for kind in ("refine", "transpose"):
                by_run = {run: {b: n for (key, b), n in c[kind].items() if key == level.key}
                          for run, c in runs.items()}
                for nrows in sorted(set().union(*by_run.values())):
                    label = f"{name} L{lv} B={nrows}"
                    key = label if dtype == "float64" else f"{label} {dtype}"
                    if key not in kres:
                        raise AssertionError(
                            f"the main path launched icr_{kind} at {key}, a shape that phase "
                            f"17 did not hold against the plain version and time")
                    r = kres[key]
                    first = next(c[nrows] for c in by_run.values() if c.get(nrows))
                    entries.append(dict(
                        name=f"icr_{kind} (K9, {label}, {level.coarse_shape} -> "
                             f"{level.fine_shape}, {dtype})",
                        route="cuda", source=src,
                        replaces=f"{replaces} (XLA in the JAX package, not Pallas)",
                        launches=first,
                        launches_by_run={run: c.get(nrows, 0) for run, c in by_run.items()},
                        max_abs_err=r[f"{kind}_err"], ms=r[f"{kind}_device_ms"],
                        plain_ms=r[f"{kind}_plain_device_ms" if kind == "refine"
                                   else "transpose_plain_ms"],
                        bound_ms=r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
                        library_ms=r[f"{kind}_library_ms"],
                    ))
    return entries


# -- spherical correlated fields (phases 22-24) ---------------------------------

HP_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# phase 23: demo 16's seed (truth, noise, start), and the KL energy it ended
# at on an NVIDIA H100 when K10 summed over m directly at every pixel (the
# ring FFTs round otherwise, and CG carries that into the energy)
DEMO16_SEED = 33
DEMO16_DIRECT_SUM_ENERGY = 548180.5151734444


def hp_bound_ms(rings, nm, nrows, size, peak_ops_per_s):
    """The least time of one K10 call (either direction) on the card: the
    planes (B, 2, nm, nrings) read or written once and the maps (B, npix)
    written or read once, over the memory rate, or the ring FFT form's
    operations, 2.5 n log2 n a ring of n pixels and row, over the arithmetic
    rate, whichever is larger; and which of the two that is."""
    by_bytes = 1e3 * nrows * (2 * nm * rings.nrings + rings.npix) * size / PEAK_BYTES_PER_S
    n = rings.ring_len.astype(np.float64)
    by_ops = 1e3 * nrows * float(np.sum(2.5 * n * np.log2(n))) / peak_ops_per_s
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def hp_ring_sample(rings, nside, count=48):
    """An HPRings of a sample of the HEALPix grid's rings (`count` spread
    from pole to pole, and the first, last and longest of those whose
    transforms run in the workspace), on the host, with the indices of its
    pixels and rings in the grid's (int64 tensors)."""
    from nifty_tpu_torch.ops import healpix as hpx
    from nifty_tpu_torch.ops import hp_longitude as hl

    ws = np.flatnonzero(rings.ws_at.cpu().numpy() >= 0)
    picks = set(np.linspace(0, rings.nrings - 1, count).round().astype(int).tolist())
    if ws.size:
        picks |= {int(ws[0]), int(ws[-1]), int(ws[np.argmax(rings.ring_len[ws])])}
    rsel = np.array(sorted(picks), dtype=np.int64)
    start = rings.ring_start.cpu().numpy()
    pix = np.concatenate([np.arange(start[r], start[r + 1]) for r in rsel])
    sub = hl.HPRings(*hpx.pix2ang(nside, pix))
    return sub, torch.from_numpy(pix), torch.from_numpy(rsel)


def check_k10(label, rings, nm, F, ct, want, against, select=None):
    """K10 and its adjoint on planes `F` and cotangents `ct`: bitwise
    repeats, bitwise equal when replayed from a CUDA graph, and within
    HP_RTOL of the per-output sum of |term| of `want` (the synthesis's and
    the adjoint's outputs of the reference named `against`; where `select`
    is (pixels, rings), the reference's outputs at those pixels and rings).
    Returns both outputs and both relative errors."""
    from nifty_tpu_torch.ops import hp_longitude as hl

    dtype = F.dtype
    y1, y2 = hl.hp_longitude(F, rings), hl.hp_longitude(F, rings)
    g1, g2 = hl.hp_longitude_adjoint(ct, rings, nm), hl.hp_longitude_adjoint(ct, rings, nm)
    torch.cuda.synchronize()
    if not (torch.equal(y1, y2) and torch.equal(g1, g2)):
        raise AssertionError(f"the K10 kernels do not repeat ({label}, {dtype})")
    if not (torch.equal(y1, replayed(lambda: hl.hp_longitude(F, rings)))
            and torch.equal(g1, replayed(lambda: hl.hp_longitude_adjoint(ct, rings, nm)))):
        raise AssertionError(
            f"the K10 kernels differ when replayed from a CUDA graph ({label}, {dtype})")
    tiny = torch.finfo(dtype).tiny
    pix, rsel = select if select is not None else (slice(None), slice(None))
    rels = [float(((got - ref).abs() / scale.clamp_min(tiny)).max())
            for got, ref, scale in (
                (y1[:, pix], want[0], hl.sum_abs_terms(rings, F=F)[:, pix]),
                (g1[..., rsel], want[1], hl.sum_abs_terms(rings, ct=ct)[..., rsel]))]
    if max(rels) > HP_RTOL[dtype]:
        raise AssertionError(f"the K10 kernels are off {against} by {rels} of the per-output "
                             f"sum of |term| ({label}, {dtype})")
    return y1, g1, rels


@phase("22 the HEALPix longitude kernels (K10) vs plain")
def phase_hp_kernels(cases, wide, f32=()):
    """`cases`: {label: (HPRings on the card, nm, rows)}.  K10 and its
    adjoint against the plain versions in float64 and float32 (within 1e-12
    / 1e-5 of the per-output sum of |term|), bitwise reproducible and
    bitwise equal when replayed from a CUDA graph; float64 device ms (50
    calls in a replayed CUDA graph) beside the bound, the ``torch.fft``
    route's (5 calls in a replayed CUDA graph), the plain versions' and the
    stored-table route's ms (CUDA events around 5 calls).  `wide`: {label:
    (nside, nm, rows)}, the same for a HEALPix grid whose plain versions'
    phase chunks would not fit the card (nside 2048, whose polar rings'
    transforms run in the workspace): held against the plain versions on a
    sample of its rings (:func:`hp_ring_sample`), timed beside the bound
    (the ``torch.fft`` route would first build a cuFFT plan for each of
    its 2048 ring lengths).  The labels of `cases` in `f32` (the shape phase
    46's float32 leg launches) are timed in float32 too, under
    `"<label> float32"`: the kernels, the ``torch.fft`` route and the plain
    versions (not the stored tables)."""
    from nifty_tpu_torch.ops import hp_longitude as hl

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    results, tables = {}, {}
    for label, (rings, nm, nrows) in cases.items():
        # held in both types at every row count; timed in float64: the
        # main path's shape (one row, phase 23) with the plain versions'
        # and the stored tables' times, the other rows the kernels and the
        # torch.fft route
        for dtype in (torch.float64, torch.float32):
            F = torch.randn((nrows, 2, nm, rings.nrings), dtype=dtype, device=dev, generator=gen)
            ct = torch.randn((nrows, rings.npix), dtype=dtype, device=dev, generator=gen)
            y_plain, g_plain = hl.hp_longitude_plain(F, rings), hl.hp_longitude_adjoint_plain(
                ct, rings, nm)
            y1, g1, rels = check_k10(label, rings, nm, F, ct, (y_plain, g_plain),
                                     "their plain versions")
            if dtype == torch.float32 and label not in f32:
                continue
            r = dict(synth_err=float((y1 - y_plain).abs().max()),
                     adjoint_err=float((g1 - g_plain).abs().max()),
                     synth_rel=rels[0], adjoint_rel=rels[1])
            r["synth_device_ms"] = device_ms(lambda: hl.hp_longitude(F, rings))
            r["adjoint_device_ms"] = device_ms(lambda: hl.hp_longitude_adjoint(ct, rings, nm))
            # the torch.fft route builds a cuFFT plan for every ring length
            # and number of rows (seconds each time): timed at one row, the
            # rows the main path launches
            r["synth_library_ms"] = r["adjoint_library_ms"] = None
            if nrows == 1:
                r["synth_library_ms"] = device_ms(lambda: hl.hp_longitude_fft_route(F, rings), n=5)
                r["adjoint_library_ms"] = device_ms(
                    lambda: hl.hp_longitude_adjoint_fft_route(ct, rings, nm), n=5)
            bound = hp_bound_ms(rings, nm, nrows, F.element_size(), PEAK_OPS_PER_S[dtype])
            r["synth_bound_ms"], r["synth_bound_by"] = bound
            r["adjoint_bound_ms"], r["adjoint_bound_by"] = bound
            if dtype == torch.float32:
                r["synth_plain_ms"] = cuda_ms(lambda: hl.hp_longitude_plain(F, rings), n=5)
                r["adjoint_plain_ms"] = cuda_ms(
                    lambda: hl.hp_longitude_adjoint_plain(ct, rings, nm), n=5)
                results[f"{label} float32"] = r
                print(f"{label}: planes ({nrows}, 2, {nm}, {rings.nrings}) <-> maps ({nrows}, "
                      f"{rings.npix}) | float32 ms: synthesis {r['synth_device_ms']:.5f} "
                      f"({100 * bound[0] / r['synth_device_ms']:.1f} % of the bound; torch.fft "
                      f"route {r['synth_library_ms']:.4f}, plain {r['synth_plain_ms']:.4f}) | "
                      f"adjoint {r['adjoint_device_ms']:.5f} "
                      f"({100 * bound[0] / r['adjoint_device_ms']:.1f} %; torch.fft route "
                      f"{r['adjoint_library_ms']:.4f}, plain {r['adjoint_plain_ms']:.4f}) | "
                      f"bound {bound[0]:.5f} by {bound[1]} | rel err of sum|term| "
                      f"{rels[0]:.2e} / {rels[1]:.2e}, max abs err {r['synth_err']:.3e} / "
                      f"{r['adjoint_err']:.3e}", flush=True)
                continue
            results[label] = r
            if nrows > 1:
                print(f"{label}: planes ({nrows}, 2, {nm}, {rings.nrings}) <-> maps ({nrows}, "
                      f"{rings.npix}) | float64 ms: synthesis {r['synth_device_ms']:.5f} | "
                      f"adjoint {r['adjoint_device_ms']:.5f} | bound {bound[0]:.5f} by "
                      f"{bound[1]} | rel err of sum|term| {rels[0]:.2e} / {rels[1]:.2e}",
                      flush=True)
                continue
            key = (rings.npix, nm)
            if key not in tables:
                t0 = time.perf_counter()
                tables[key] = hl.phase_tables(rings, nm, torch.float64)
                torch.cuda.synchronize()
                print(f"stored phase tables for npix {rings.npix}, nm {nm}: "
                      f"{sum(t.numel() * t.element_size() for t in tables[key]) / 2**30:.2f} "
                      f"GiB, built in {time.perf_counter() - t0:.3f} s",
                      flush=True)
            cs = tables[key]

            def synth_t():
                return hl.hp_longitude_plain(F, rings, cs)

            def adjoint_t():
                return hl.hp_longitude_adjoint_plain(ct, rings, nm, cs)

            for got, want in ((synth_t(), y_plain), (adjoint_t(), g_plain)):
                if float((got - want).abs().max()) > 1e-12 * float(want.abs().max()):
                    raise AssertionError(f"the stored-table route disagrees ({label})")
            r["synth_plain_ms"] = cuda_ms(lambda: hl.hp_longitude_plain(F, rings), n=5)
            r["adjoint_plain_ms"] = cuda_ms(
                lambda: hl.hp_longitude_adjoint_plain(ct, rings, nm), n=5)
            r["synth_table_ms"] = cuda_ms(synth_t, n=5)
            r["adjoint_table_ms"] = cuda_ms(adjoint_t, n=5)
            print(
                f"{label}: planes ({nrows}, 2, {nm}, {rings.nrings}) <-> maps ({nrows}, "
                f"{rings.npix}) | float64 ms: synthesis {r['synth_device_ms']:.5f} "
                f"({100 * bound[0] / r['synth_device_ms']:.1f} % of the bound; torch.fft route "
                f"{r['synth_library_ms']:.4f}, plain {r['synth_plain_ms']:.4f}, stored tables "
                f"{r['synth_table_ms']:.4f}) | adjoint {r['adjoint_device_ms']:.5f} "
                f"({100 * bound[0] / r['adjoint_device_ms']:.1f} %; torch.fft route "
                f"{r['adjoint_library_ms']:.4f}, plain {r['adjoint_plain_ms']:.4f}, stored tables "
                f"{r['adjoint_table_ms']:.4f}) | bound {bound[0]:.5f} by {bound[1]} | shared "
                f"memory a block {rings.smem_bytes(nm, False)} / {rings.smem_bytes(nm, True)} "
                f"bytes | rel err of sum|term| {rels[0]:.2e} / {rels[1]:.2e}, max abs err "
                f"{r['synth_err']:.3e} / {r['adjoint_err']:.3e}",
                flush=True,
            )
    del tables
    torch.cuda.empty_cache()
    for label, (nside, nm, nrows) in wide.items():
        t0 = time.perf_counter()
        rings = hl.healpix_rings(nside).to(dev)
        sub, pix, rsel = hp_ring_sample(rings, nside)
        print(f"the ring table of nside {nside} ({rings.npix} pixels, {rings.nrings} rings) "
              f"and a sample of {sub.nrings} of its rings ({sub.npix} pixels) built in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        sub, pix, rsel = sub.to(dev), pix.to(dev), rsel.to(dev)
        for dtype in (torch.float64, torch.float32):
            F = torch.randn((nrows, 2, nm, rings.nrings), dtype=dtype, device=dev, generator=gen)
            ct = torch.randn((nrows, rings.npix), dtype=dtype, device=dev, generator=gen)
            want = (hl.hp_longitude_plain(F[..., rsel].contiguous(), sub),
                    hl.hp_longitude_adjoint_plain(ct[:, pix].contiguous(), sub, nm))
            _, _, rels = check_k10(label, rings, nm, F, ct, want,
                                   f"their plain versions on {sub.nrings} rings", (pix, rsel))
            del want
            if dtype != torch.float64:
                continue
            r = dict(synth_rel=rels[0], adjoint_rel=rels[1])
            r["synth_device_ms"] = device_ms(lambda: hl.hp_longitude(F, rings), n=10)
            r["adjoint_device_ms"] = device_ms(lambda: hl.hp_longitude_adjoint(ct, rings, nm),
                                               n=10)
            # (the torch.fft route here needs a cuFFT plan for each of 2048
            # ring lengths: timed once, PERF.md; not rebuilt in every run)
            bound = hp_bound_ms(rings, nm, nrows, F.element_size(), PEAK_OPS_PER_S[dtype])
            r["bound_ms"], r["bound_by"] = bound
            results[label] = r
            print(
                f"{label}: planes ({nrows}, 2, {nm}, {rings.nrings}) <-> maps ({nrows}, "
                f"{rings.npix}), {int(np.sum(rings.ws_at.cpu().numpy() >= 0))} rings in the "
                f"workspace ({rings.ws_row * 16 * nrows / 2**20:.0f} MiB) | float64 ms: "
                f"synthesis {r['synth_device_ms']:.5f} ({100 * bound[0] / r['synth_device_ms']:.1f}"
                f" % of the bound) | adjoint {r['adjoint_device_ms']:.5f} "
                f"({100 * bound[0] / r['adjoint_device_ms']:.1f} %) | bound {bound[0]:.5f} by "
                f"{bound[1]} | shared memory a block "
                f"{rings.smem_bytes(nm, False)} / "
                f"{rings.smem_bytes(nm, True)} bytes | rel err of sum|term| on the sample "
                f"{rels[0]:.2e} / {rels[1]:.2e}",
                flush=True,
            )
        del F, ct, rings
        torch.cuda.empty_cache()
    return results


def hp_counts():
    """K10's calls of the kernel route, by (npix, nm, rows)."""
    from nifty_tpu_torch.ops import hp_longitude as hl

    return {"synth": dict(hl.hp_longitude.launches_by_shape),
            "adjoint": dict(hl.hp_longitude_adjoint.launches_by_shape)}


def hp_text(counts):
    return " ".join(f"{kind} " + ", ".join(f"npix {npix} nm {nm} B={b}: {n}"
                                          for (npix, nm, b), n in sorted(c.items()))
                    for kind, c in counts.items())


def demo16_likelihood(jt, sky):
    """`demos/16_spherical_cf.py`'s data: the truth from the prior (latents
    drawn on the host from the seed), noise 0.5 on the pixels within 0.1 of
    the middle of the ring order (the equatorial band) and 0.1 elsewhere
    (numpy, from the seed).  Returns the likelihood, the truth and the keys
    of the start and of `optimize_kl`."""
    k_truth, k_init, k_opt = jt.HostKey(DEMO16_SEED).split(3)
    with torch.no_grad():
        truth = sky(sky.init(k_truth))
    npix = truth.shape[-1]
    ring = np.abs(np.arange(npix) / npix - 0.5)
    noise_std = torch.from_numpy(np.where(ring < 0.1, 0.5, 0.1)).to(truth)
    noise = np.random.default_rng(DEMO16_SEED).standard_normal(npix)
    data = truth + noise_std * torch.from_numpy(noise).to(truth)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std ** 2).amend(sky)
    return lh, truth, (k_init, k_opt)


DEMO16_KWARGS = dict(
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=60)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=3, cg_kwargs=dict(maxiter=25))),
    kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=8, cg_kwargs=dict(maxiter=40))),
    sample_mode="nonlinear_resample")


def demo16_fit(jt, lh, k_init, k_opt, n_iters, n_samples, marks, firsts=None):
    """The demo's `optimize_kl` from 0.1 times a latent draw; `marks` gets
    the time after each iteration, `firsts` (a list) the first iteration's
    KL energy and the peak allocation after it."""
    position = {k: 0.1 * v for k, v in lh.init(k_init).items()}

    def clock(samples, state):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if firsts is not None and not firsts:
            firsts.extend([float(state.minimization_state.fun),
                           torch.cuda.max_memory_allocated()])

    return jt.optimize_kl(
        lh, position, key=k_opt, n_total_iterations=n_iters, n_samples=n_samples,
        residual_map="smap", kl_map="smap", callback=clock, **DEMO16_KWARGS)


def demo16_witness(jt, lh, k_init, k_opt, n_iters, n_samples, energy):
    """The same fit with K10 and its adjoint replaced by their ``torch.fft``
    route (the same ring FFTs, rounded otherwise): its KL energy beside the
    kernel's.  Fails if a K10 kernel launched in it."""
    from nifty_tpu_torch.ops import hp_longitude as hl

    kernels = hl.hp_longitude, hl.hp_longitude_adjoint
    launches = [fn.launches for fn in kernels]
    hl.hp_longitude = hl.hp_longitude_fft_route
    hl.hp_longitude_adjoint = hl.hp_longitude_adjoint_fft_route
    try:
        marks = [time.perf_counter()]
        _, state = demo16_fit(jt, lh, k_init, k_opt, n_iters, n_samples, marks)
    finally:
        hl.hp_longitude, hl.hp_longitude_adjoint = kernels
    if [fn.launches for fn in kernels] != launches:
        raise AssertionError("the witness fit launched a K10 kernel")
    route = float(state.minimization_state.fun)
    print(f"demo 16 witness, K10 as its torch.fft route: KL energy {route!r} in "
          f"{marks[-1] - marks[0]:.3f} s; the kernel's {energy!r}, relative "
          f"{(route - energy) / energy:.3e}; the direct sum's {DEMO16_DIRECT_SUM_ENERGY!r}, "
          f"relative {(route - DEMO16_DIRECT_SUM_ENERGY) / DEMO16_DIRECT_SUM_ENERGY:.3e}",
          flush=True)


@phase("23 demos/16_spherical_cf.py: optimize_kl on a HEALPix sky, nside 256, lmax 511")
def phase_demo16(jt, sky, with_profile, with_witness=False):
    """`demos/16_spherical_cf.py` as written: the sky observed directly
    (`demo16_likelihood`), `optimize_kl` with 4 iterations of 4 pairs from
    0.1 times a latent draw, the sample loop for both stages.  The demo's
    check: the posterior mean's rms error below the truth's rms.
    `with_witness`: then :func:`demo16_witness`.  Returns the distributor's
    and K10's counts, and the likelihood, the keys and the first
    iteration's :func:`reference` (phase 46's)."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops import hp_longitude as hl

    lh, truth, (k_init, k_opt) = demo16_likelihood(jt, sky)
    npix = truth.shape[-1]
    n_iters, n_samples = 4, 4
    torch.cuda.reset_peak_memory_stats()
    bg.reset_launch_counts()
    hl.reset_launch_counts()
    base, firsts = torch.cuda.memory_allocated(), []
    marks = [time.perf_counter()]
    samples, state = demo16_fit(jt, lh, k_init, k_opt, n_iters, n_samples, marks, firsts)
    ref = dict(energy=firsts[0], peak=(firsts[1] - base) / 2 ** 30, seconds=marks[1] - marks[0])
    counts, k10 = launch_counts(bg), hp_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        post_mean = torch.stack([sky(s) for s in samples]).mean(0)
    err = float(torch.sqrt(torch.mean((post_mean - truth) ** 2)))
    prior_rms = float(truth.std(correction=0))
    seconds = [b - a for a, b in zip(marks, marks[1:])]
    energy = float(state.minimization_state.fun)
    sht = sky.spherical_transform.sht
    print(f"demo 16 optimize_kl (nside {sht.nside}, lmax {sht.lmax}, {npix} pixels): s/iteration "
          f"{[round(x, 3) for x in seconds]} ({sum(seconds):.3f} s) | geoVI samples/s "
          f"{2 * n_samples * n_iters / sum(seconds):.4f} | KL energy {energy!r} (relative to the "
          f"direct sum's {DEMO16_DIRECT_SUM_ENERGY!r}: "
          f"{(energy - DEMO16_DIRECT_SUM_ENERGY) / DEMO16_DIRECT_SUM_ENERGY:.3e}) | peak mem "
          f"{peak:.2f} GiB | posterior mean rms error {err:.4f} against the prior rms "
          f"{prior_rms:.4f} | {len(samples)} samples | K10 calls: {hp_text(k10)} | distributor "
          f"calls by rows: {rows_text(counts)}", flush=True)
    if not np.isfinite(energy):
        raise AssertionError(f"demo 16: non-finite KL energy {energy}")
    if min(sum(c.values()) for c in k10.values()) <= 0:
        raise AssertionError(f"demo 16: a K10 kernel never launched: {k10}")
    require_launches("demo 16", counts, (sky.dist,))
    if not err < prior_rms:
        raise AssertionError(f"demo 16: the posterior mean (rms error {err}) is no better than "
                             f"the prior ({prior_rms})")
    if with_profile:
        profile_update(jt, "demo 16 sky", lh, residual_map="smap", kl_map="smap")
    if with_witness:
        demo16_witness(jt, lh, k_init, k_opt, n_iters, n_samples, energy)
    return counts, k10, (lh, k_init, k_opt, ref)


def hp_kernel_entries(kres, runs, rings, nm, nside, dtype="float64"):
    """The `kernels` line's entries of K10 and its adjoint: one for each
    direction and number of rows that the runs ({run: K10 counts})
    launched at this grid, with phase 22's numbers; fails on a shape that
    phase 22 did not check."""
    src = "nifty_tpu_torch/csrc/hp_longitude.cu"
    tpu = "nifty_tpu/ops/healpix_sht.py"
    entries = []
    for kind, name, line in (("synth", "hp_longitude", 51),
                             ("adjoint", "hp_longitude_adjoint", 78)):
        by_run = {run: {b: n for (npix, m, b), n in c[kind].items()
                        if (npix, m) == (rings.npix, nm)}
                  for run, c in runs.items()}
        for nrows in sorted(set().union(*by_run.values())):
            label = f"nside {nside} mmax {nm - 1} B={nrows}"
            key = label if dtype == "float64" else f"{label} {dtype}"
            if key not in kres:
                raise AssertionError(f"the main path launched {name} at {key}, a shape that "
                                     f"phase 22 did not hold against the plain version and time")
            r = kres[key]
            entries.append(dict(
                name=f"{name} (K10, {label}, {dtype})", route="cuda", source=src,
                replaces=f"{tpu}:{line} (XLA in the JAX package, not Pallas)",
                launches=next(c[nrows] for c in by_run.values() if c.get(nrows)),
                launches_by_run={run: c.get(nrows, 0) for run, c in by_run.items()},
                max_abs_err=r[f"{kind}_err"], ms=r[f"{kind}_device_ms"],
                plain_ms=r[f"{kind}_plain_ms"],
                **({"table_ms": r[f"{kind}_table_ms"]} if f"{kind}_table_ms" in r else {}),
                bound_ms=r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
                library_ms=r[f"{kind}_library_ms"],
            ))
    return entries


# -- line-of-sight tomography (phases 25-28) -------------------------------

LOS_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# `demos/1_tomography.py`'s seeds (its rays come from numpy's generator 5);
# phase 28's are `tests/test_tomography_3d.py`'s (rays from 7)
DEMO1_SEED = 87
NUTS_SEED = 7
# phase 28: NUTS transitions, of which the last half are kept
NUTS_TRANSITIONS = 80


#: `main_at_scale()`'s budgets (phases 27 and 44): draw CG 40; geoVI 3 x CG
#: 15, `xtol` 1e-3; KL 6 x CG 20, `xtol` 1e-4; 2 pairs
TOMO256_KWARGS = dict(
    n_samples=2, draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=40)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=3, cg_kwargs=dict(maxiter=15))),
    kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=6, cg_kwargs=dict(maxiter=20))),
    sample_mode="nonlinear_resample")
#: phases 27's and 44's grid, rays (from numpy's generator 5) and points;
#: their field has `n_bins=128`
TOMO256_RAYS = dict(dims=(256,) * 3, n_rays=1024, n_points=256, ray_seed=5)


def tomography_rays(jt, dims, n_rays, n_points, ray_seed):
    """The response of :func:`tomography_model`: `n_rays` rays between
    uniform points in [0.05, 0.95]^3 (numpy, from `ray_seed`) sampled at
    `n_points` points."""
    rng = np.random.default_rng(ray_seed)
    start = rng.uniform(0.05, 0.95, size=(n_rays, 3))
    end = rng.uniform(0.05, 0.95, size=(n_rays, 3))
    return jt.SamplingCartesianGridLOS(start, end, shape=dims,
                                       distances=tuple(1.0 / d for d in dims),
                                       n_sampling_points=n_points)


def tomography_model(jt, dims, n_rays, n_points, ray_seed, flexible=True, n_bins=None,
                     hartley_fn=None):
    """The forward model of `demos/1_tomography.py` (`main()`: no
    flexibility or asperity; `main_at_scale()`: both, and `n_bins`) and of
    `tests/test_tomography_3d.py` (both): a correlated field `cf` on `dims`
    (its Hartley transform `hartley_fn`, the local one by default), the
    rays of :func:`tomography_rays`, the model x -> los(exp(cf(x))) with
    the field and the response as submodules (so that `shard_position`
    reaches both).  Returns the model, `cf` and the
    response."""
    cf = tomography_field(jt, dims, flexible, n_bins, hartley_fn)
    los = tomography_rays(jt, dims, n_rays, n_points, ray_seed)
    return los_model(jt, cf, los), cf, los


def tomography_field(jt, dims, flexible=True, n_bins=None, hartley_fn=None):
    """:func:`tomography_model`'s correlated field."""
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    kw = dict(flexibility=(1e0, 5e-1), asperity=(5e-1, 5e-2)) if flexible else {}
    if n_bins is not None:
        kw["n_bins"] = n_bins
    cfm.add_fluctuations(dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-4.0, 5e-1), **kw)
    return cfm.finalize(hartley_fn=hartley_fn)


def los_model(jt, cf, los):
    """x -> los(exp(cf(x))), the field and the response as submodules."""
    fwd = jt.Model(lambda x: los(torch.exp(cf(x))), domain=cf.domain, init=cf.init)
    fwd.cf, fwd.los = cf, los
    return fwd


def build_tomography(jt, dims, n_rays, n_points, ray_seed, key, flexible=True, n_bins=None):
    """:func:`tomography_model`'s likelihood: data from a prior draw
    (latents drawn on the host from `key`) plus white noise of 5 % of the
    mean |truth|.  Returns the likelihood, `cf`, the response and the
    noise's standard deviation."""
    fwd, cf, los = tomography_model(jt, dims, n_rays, n_points, ray_seed, flexible, n_bins)
    k_truth, k_noise = jt.HostKey(key).split(2)
    with torch.no_grad():
        truth = fwd(fwd.init(k_truth))
        noise_std = 0.05 * float(truth.abs().mean())
        data = truth + noise_std * jt.random_like(k_noise, truth)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std ** 2).amend(fwd)
    return lh, cf, los, noise_std


def reduced_chi2(lh, samples):
    """The mean over samples of the mean squared normalized data residual."""
    with torch.no_grad():
        return float(torch.stack([torch.mean(lh.normalized_residual(s) ** 2)
                                  for s in samples]).mean())


def los_counts():
    """K11's calls of the kernel route, by (table key, rows)."""
    from nifty_tpu_torch.ops import los_interp as li

    return {"forward": dict(li.los_integrate.launches_by_shape),
            "adjoint": dict(li.los_integrate_adjoint.launches_by_shape)}


def slab_counts():
    """`los_slab_forward`'s calls, by (slab key, rows)."""
    from nifty_tpu_torch.ops import los_interp as li

    return dict(li.slab_row_partials.launches_by_shape)


def slab_text(counts):
    return ", ".join(f"{grid_text(grid)} rows {rows[0]}-{rows[1] - 1} x {nrays} rays B={b}: {n}"
                     for ((grid, rows, nrays), b), n in sorted(counts.items()))


def los_text(counts):
    return " ".join(f"{kind} " + ", ".join(
        f"{grid_text(shape[0])} x {shape[1]} rays x {shape[2]} entries B={b}: {n}"
        for (shape, b), n in sorted(c.items())) for kind, c in counts.items())


def require_los_launches(label, counts):
    if min(sum(c.values()) for c in counts.values()) <= 0:
        raise AssertionError(f"{label}: a K11 kernel never launched: {counts}")


def los_bound_ms(tab, nrows, size, adjoint):
    """The least time of one K11 call: every input the function needs read
    once (the index and weight tables, the rays' scales, and the touched
    cells' values or the cotangents) and its output written once, over the
    memory rate, or its multiply-adds over the arithmetic rate, whichever is
    larger; and which of the two that is."""
    entries = tab.nrays * tab.nent
    tables = entries * (4 + size) + tab.nrays * size
    values = nrows * (tab.nrays if adjoint else tab.n_touched) * size
    out = nrows * (tab.ncells if adjoint else tab.nrays) * size
    by_bytes = 1e3 * (tables + values + out) / PEAK_BYTES_PER_S
    by_ops = 1e3 * 2 * nrows * tab.n_valid / PEAK_OPS_PER_S[torch.float64]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def los_library_routes(tab, f, ybar):
    """One PyTorch call for each direction on the same inputs, which the
    port never calls: the forward as ``torch.sparse.mm`` of the rays' CSR
    matrix (the valid entries' weights) times the scales, the adjoint as
    ``index_add_`` of the entries' terms."""
    valid = (tab.idx >= 0).reshape(-1)
    cols = tab.idx.reshape(-1)[valid]
    crow = torch.zeros(tab.nrays + 1, dtype=torch.int64, device=f.device)
    crow[1:] = torch.cumsum((tab.idx >= 0).sum(1), 0)
    matrix = torch.sparse_csr_tensor(crow, cols.long(), tab.w.reshape(-1)[valid],
                                     (tab.nrays, tab.ncells))

    def forward():
        return torch.sparse.mm(matrix, f.T).T * tab.scale

    def adjoint():
        terms = (tab.w * (ybar * tab.scale)[:, :, None]).reshape(ybar.shape[0], -1)[:, valid]
        return ybar.new_zeros((ybar.shape[0], tab.ncells)).index_add_(1, cols, terms)

    return forward, adjoint


def ptxas_lines(library, kernels):
    """The registers and spills of each kernel of `library` whose name is
    one of `kernels` (an alternation), from ``-Xptxas -v`` of the build in
    this process: ``name<type, template ints ...>: N registers, S bytes
    spill stores, L bytes spill loads``."""
    from nifty_tpu_torch.ops.cuda_build import BUILD_LOG

    if library not in BUILD_LOG:
        return [f"({library} was not compiled in this process)"]
    lines, name = [], None
    for line in BUILD_LOG[library][1].splitlines():
        entry = re.search(rf"({kernels})I([df])((?:L[ib]\d+E)*)E", line)
        if entry:
            args = ["double" if entry[2] == "d" else "float"]
            args += re.findall(r"L[ib](\d+)E", entry[3])
            name, spills = f"{entry[1]}<{', '.join(args)}>", None
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            lines.append(f"{name}: {regs} registers, {spills}")
            name = None
    return lines


def los_ptxas_lines():
    """Each K11 kernel's registers and spills (:func:`ptxas_lines`)."""
    return ptxas_lines("los_interp", "los_forward|los_adjoint|los_slab_forward")


@phase("25 the ray integral kernels (K11) vs plain")
def phase_los_kernels(cases, f32=()):
    """`cases`: {label: (SamplingCartesianGridLOS, rows)}.  K11 and its
    adjoint against their plain versions in float64 and float32 (within
    1e-12 / 1e-5 of the per-output sum of |term|), bitwise reproducible,
    bitwise equal when replayed from a CUDA graph, and each row of a B-row
    call bitwise equal to a one-row call on that row, in both directions;
    each kernel's registers and spills (printed once); float64 device ms
    (50 calls in a replayed CUDA graph) beside the bound and the share of
    it reached, the plain versions' and the library routes' ms (CUDA events
    around 5 calls).  Returns the results by (table key, rows); the labels
    in `f32` (the shapes phase 46's float32 legs launch) are timed in
    float32 too, under (table key, rows, "float32")."""
    from nifty_tpu_torch.ops import los_interp as li

    for line in los_ptxas_lines():
        print(f"K11 build: {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    results = {}
    for label, (los, nrows) in cases.items():
        for dtype in (torch.float64, torch.float32):
            tab = los.table(dtype)
            f = torch.randn((nrows, tab.ncells), dtype=dtype, device=dev, generator=gen)
            ybar = torch.randn((nrows, tab.nrays), dtype=dtype, device=dev, generator=gen)
            y1, y2 = li.los_integrate(f, tab), li.los_integrate(f, tab)
            g1, g2 = li.los_integrate_adjoint(ybar, tab), li.los_integrate_adjoint(ybar, tab)
            torch.cuda.synchronize()
            if not (torch.equal(y1, y2) and torch.equal(g1, g2)):
                raise AssertionError(f"the K11 kernels do not repeat ({label}, {dtype})")
            if not (torch.equal(y1, replayed(lambda: li.los_integrate(f, tab)))
                    and torch.equal(g1, replayed(lambda: li.los_integrate_adjoint(ybar, tab)))):
                raise AssertionError(
                    f"the K11 kernels differ when replayed from a CUDA graph ({label}, {dtype})")
            for b in range(nrows):
                if not (torch.equal(li.los_integrate(f[b:b + 1].contiguous(), tab), y1[b:b + 1])
                        and torch.equal(li.los_integrate_adjoint(ybar[b:b + 1].contiguous(), tab),
                                        g1[b:b + 1])):
                    raise AssertionError(f"row {b} of the K11 kernels' {nrows}-row call differs "
                                         f"from its one-row call ({label}, {dtype})")
            tiny = torch.finfo(dtype).tiny
            plain = li.los_integrate_plain(f, tab), li.los_integrate_adjoint_plain(ybar, tab)
            scales = li.sum_abs_terms(tab, f=f), li.sum_abs_terms(tab, ybar=ybar)
            rels = [float(((got - want).abs() / scale.clamp_min(tiny)).max())
                    for got, want, scale in zip((y1, g1), plain, scales)]
            if max(rels) > LOS_RTOL[dtype]:
                raise AssertionError(f"the K11 kernels are off their plain versions by {rels} "
                                     f"of the per-output sum of |term| ({label}, {dtype})")
            if dtype == torch.float32 and label not in f32:
                continue
            r = dict(forward_err=float((y1 - plain[0]).abs().max()),
                     adjoint_err=float((g1 - plain[1]).abs().max()),
                     forward_rel=rels[0], adjoint_rel=rels[1])
            r.update(los_timings(li, tab, f, ybar, plain, scales, nrows, label))
            name = str(dtype).replace("torch.", "")
            results[(tab.key, nrows) if dtype == torch.float64
                    else (tab.key, nrows, name)] = r
            print(
                f"{label}: {tab.nrays} rays x {tab.nent} entries ({tab.n_valid} valid, "
                f"{tab.n_touched} cells touched) over {tab.ncells} cells | {name} ms: forward "
                f"{r['forward_device_ms']:.5f} "
                f"({100 * r['forward_bound_ms'] / r['forward_device_ms']:.1f} % of its bound "
                f"{r['forward_bound_ms']:.5f}; plain {r['forward_plain_ms']:.4f}, torch.sparse.mm "
                f"{r['forward_library_ms']:.4f}) | adjoint {r['adjoint_device_ms']:.5f} "
                f"({100 * r['adjoint_bound_ms'] / r['adjoint_device_ms']:.1f} % of "
                f"{r['adjoint_bound_ms']:.5f}; plain {r['adjoint_plain_ms']:.4f}, index_add_ "
                f"{r['adjoint_library_ms']:.4f}) | rel err of sum|term| {rels[0]:.2e} / "
                f"{rels[1]:.2e}, max abs err {r['forward_err']:.3e} / {r['adjoint_err']:.3e}",
                flush=True,
            )
    return results


#: how far a library route may lie from the plain version, of the sum of
#: |term| an output
LIBRARY_RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def los_timings(li, tab, f, ybar, plain, scales, nrows, label):
    """Phase 25's numbers of one table, rows and dtype: the kernels' device
    ms, the plain versions' and the library routes' ms (the routes held to
    the plain versions first) and the bounds."""
    tiny = torch.finfo(f.dtype).tiny
    lib_fwd, lib_adj = los_library_routes(tab, f, ybar)
    for got, want, scale in zip((lib_fwd(), lib_adj()), plain, scales):
        if float(((got - want).abs() / scale.clamp_min(tiny)).max()) > LIBRARY_RTOL[f.dtype]:
            raise AssertionError(f"a library route disagrees with the plain version "
                                 f"({label}, {f.dtype})")
    r = dict(forward_device_ms=device_ms(lambda: li.los_integrate(f, tab)),
             adjoint_device_ms=device_ms(lambda: li.los_integrate_adjoint(ybar, tab)),
             forward_plain_ms=cuda_ms(lambda: li.los_integrate_plain(f, tab), n=5),
             adjoint_plain_ms=cuda_ms(lambda: li.los_integrate_adjoint_plain(ybar, tab), n=5),
             forward_library_ms=cuda_ms(lib_fwd, n=5), adjoint_library_ms=cuda_ms(lib_adj, n=5))
    for kind in ("forward", "adjoint"):
        r[f"{kind}_bound_ms"], r[f"{kind}_bound_by"] = los_bound_ms(
            tab, nrows, f.element_size(), kind == "adjoint")
    return r


#: the slabs of phase 44's worlds (a field rank of 2 x 2, and the whole grid
#: of 1 x 1) and a 16^3 one, whose tables phase 25 holds
LOS_SLAB_ROWS = {"256^3": ((0, 128), (128, 256), (0, 256)), "16^3": ((0, 8),)}


class LosPart:
    """A line-of-sight slab's own table as phase 25 holds it, by float
    type (`slabs`: {dtype: LosSlab})."""

    def __init__(self, slabs):
        self.slabs = slabs

    def table(self, dtype):
        return self.slabs[dtype].table


def los_slabs(responses):
    """{(grid, rows): {dtype: LosSlab}} of `LOS_SLAB_ROWS` from
    `responses` ({grid: SamplingCartesianGridLOS}), float64 and float32."""
    return {(grid, rows): {dt: los.slab_tables(rows, dt) for dt in (torch.float64, torch.float32)}
            for grid, los in responses.items() for rows in LOS_SLAB_ROWS[grid]}


def slab_cases(slabs):
    """Phase 25's cases of the slabs' own tables, one row each (the sample
    loop's): the adjoint, and the forward without
    `deterministic_reductions`."""
    return {f"{grid} rows {rows[0]}-{rows[1] - 1} slab table B=1": (LosPart(by_dtype), 1)
            for (grid, rows), by_dtype in slabs.items()}


def slab_library_routes(slab, f, ybar):
    """The slab's forward and adjoint as one PyTorch call each, which the
    port never calls: ``torch.sparse.mm`` of the virtual rays' CSR matrix
    (``LosSlab.partials_csr``) and of the slab table's transpose (its CSR
    by cell), times the rays' scales."""
    dev = f.device
    fwd = slab.partials_csr()
    t = slab.table
    crow = torch.zeros(slab.ncells + 1, dtype=torch.int64, device=dev)
    crow[t.cells + 1] = (t.seg_off[1:] - t.seg_off[:-1]).long()
    adj = torch.sparse_csr_tensor(torch.cumsum(crow, 0), t.seg_ray.long(), t.seg_w,
                                  (slab.ncells, slab.nrays))

    def forward():
        return torch.sparse.mm(fwd, f.T).T.reshape(f.shape[0], -1, slab.nrays)

    def adjoint():
        return torch.sparse.mm(adj, (ybar * t.scale).T).T

    return forward, adjoint


#: the digests of the (ray, row) partials from the nine-launch route that
#: the slab forward replaced (one `los_forward` launch a power-of-two width
#: of virtual rays padded with -1, placed in zeros), at each slab of
#: `LOS_SLAB_ROWS` and 1 and 3 rows in phase 25's order, on
#: `slab_bit_inputs`: the first 8 hex digits of the SHA-256 of the output's
#: bytes.  They were taken on an NVIDIA H100 80GB HBM3 at 700 W by calling
#: `slab_row_partials` of commit 2e49991 (a `git archive` of it) on these
#: inputs, in the same run on the card that first built `los_slab_forward` and
#: gave the same 16 digests.  Phase 25 holds `los_slab_forward` to them.
LOS_SLAB_PINNED = {
    "f64": "62216de2 5e763895 dc09ca13 85a2b330 bb2a6597 9efbc4a4 a6f2bb05 7078f644",
    "f32": "fe4f452d 3d5c2ff7 05af994d 86d003df 8c974666 ade3f21c 1d14c498 1a799944",
}


def slab_bit_inputs(label, slab, nrows, dtype, draws):
    """The slab forward's bit check fields ``(nrows, slab cells)``: standard
    normal draws that numpy makes in float64 from a seed of the label
    (kept on the card in `draws`, by label, for the other float type),
    rounded to `dtype`."""
    if label not in draws:
        rng = np.random.default_rng(zlib.crc32(label.encode()))
        draws[label] = torch.from_numpy(rng.standard_normal((nrows, slab.ncells))).cuda()
    return draws[label].to(dtype)


def slab_function_bytes(slab, size):
    """The bytes of the slab forward's tables that the function itself
    needs: each valid entry's cell (int32) and weight once, and each ray's
    scale."""
    return slab.table.n_valid * (4 + size) + slab.nrays * size


def slab_bound_ms(slab, nrows, size):
    """The least time of one slab forward: each valid entry's cell and
    weight, each ray's scale, the touched cells' values and the partials
    once each, over the memory rate, or its multiply-adds over the
    arithmetic rate, whichever is larger; and which of the two that is.
    The compact layout's offsets, places, descriptors, mask and a scale a
    virtual ray rather than a ray are the design's means, not the
    function's inputs: phase 25 prints their bytes beside it."""
    values = nrows * (slab.table.n_touched + slab.nout) * size
    by_bytes = 1e3 * (slab_function_bytes(slab, size) + values) / PEAK_BYTES_PER_S
    by_ops = 1e3 * 2 * nrows * slab.table.n_valid / PEAK_OPS_PER_S[torch.float64]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


@phase("25 the slabs of K11 (phase 44's worlds): los_slab_forward and the adjoint vs plain")
def phase_los_slabs(slabs):
    """Each slab's forward under `deterministic_reductions` (the (ray, row)
    partials, `los_slab_forward`) at 1 and 3 rows and its adjoint (the slab
    table's CSR by cell) on the card against their plain versions (within
    1e-12 / 1e-5 of the per-output sum of |term|), float64 and float32; the
    forward one launch a call, bitwise repeated, +0 (never -0) where a pair
    holds no virtual ray, and bitwise the nine-launch route's partials
    (`LOS_SLAB_PINNED`); at 256^3's 3 rows also bitwise when replayed from a
    CUDA graph and row by row; each
    kernel's registers and spills; float64 device ms (50 calls in a
    replayed CUDA graph) beside the bound, the plain versions (CUDA events
    around 5 calls), ``torch.sparse.mm`` of the CSR (10 calls in a
    replayed graph, and events around 5) and of its transpose (events).
    Returns the forward's numbers by (slab key, rows)."""
    from nifty_tpu_torch.ops import los_interp as li

    for line in los_ptxas_lines():
        if "los_slab_forward" in line:
            print(f"K11 slab build: {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    out, digests = {}, {"f64": [], "f32": []}
    for (grid, rows), by_dtype in slabs.items():
        draws = {}
        for dtype, slab in by_dtype.items():
            tiny = torch.finfo(dtype).tiny
            where = f"{grid}, rows {rows}, {dtype}"
            for nrows in (1, 3):
                f = slab_bit_inputs(f"{grid} rows {rows[0]}-{rows[1] - 1} B={nrows}", slab, nrows,
                                    dtype, draws)
                before = li.slab_row_partials.launches
                got = li.slab_row_partials(f, slab)
                torch.cuda.synchronize()
                if li.slab_row_partials.launches != before + 1:
                    raise AssertionError(f"los_slab_forward: not one launch a call ({where})")
                digests["f64" if dtype == torch.float64 else "f32"].append(digest(got))
                rel = float(((got - li.slab_row_partials_plain(f, slab)).abs()
                             / li.slab_sum_abs_terms(slab, f).clamp_min(tiny)).max())
                if rel > LOS_RTOL[dtype]:
                    raise AssertionError(f"los_slab_forward is off its plain version by {rel} of "
                                         f"the per-output sum of |term| ({where}, B={nrows})")
                if not torch.equal(got, li.slab_row_partials(f, slab)):
                    raise AssertionError(f"los_slab_forward does not repeat ({where}, B={nrows})")
                full = nrows > 1 and grid == "256^3"
                if full and not torch.equal(got, replayed(lambda: li.slab_row_partials(f, slab))):
                    raise AssertionError(f"los_slab_forward differs when replayed from a CUDA "
                                         f"graph ({where}, B={nrows})")
                for b in range(nrows if full else 0):
                    if not torch.equal(li.slab_row_partials(f[b:b + 1].contiguous(), slab),
                                       got[b:b + 1]):
                        raise AssertionError(f"row {b} of los_slab_forward's {nrows}-row call "
                                             f"differs from its one-row call ({where})")
                if bool(torch.signbit(got[got == 0]).any()):
                    raise AssertionError(f"los_slab_forward wrote -0 ({where}, B={nrows})")
            ybar = torch.randn((1, slab.nrays), dtype=dtype, device=dev, generator=gen)
            adj = li.los_integrate_adjoint(ybar, slab.table)
            adj_want = li.slab_adjoint_plain(ybar, slab)
            adj_rel = float(((adj - adj_want).abs() / li.sum_abs_terms(
                slab.table, ybar=ybar).clamp_min(tiny)).max())
            if adj_rel > LOS_RTOL[dtype]:
                raise AssertionError(f"the slab adjoint is off its plain version by {adj_rel} of "
                                     f"the per-output sum of |term| ({where})")
            if dtype != torch.float64:
                continue
            f = slab_bit_inputs(f"{grid} rows {rows[0]}-{rows[1] - 1} B=1", slab, 1, dtype, draws)
            want = li.slab_row_partials_plain(f, slab)
            lib_fwd, lib_adj = slab_library_routes(slab, f, ybar)
            for g, w, sc in ((lib_fwd(), want, li.slab_sum_abs_terms(slab, f)),
                             (lib_adj(), adj_want, li.sum_abs_terms(slab.table, ybar=ybar))):
                if float(((g - w).abs() / sc.clamp_min(tiny)).max()) > 1e-10:
                    raise AssertionError(f"a library route disagrees with the plain version "
                                         f"({grid}, rows {rows})")
            t = slab.table
            size = f.element_size()
            r = dict(rel=rel, adjoint_rel=adj_rel, n_virtual=slab.n_virtual, groups=slab.groups,
                     err=float((li.slab_row_partials(f, slab) - want).abs().max()),
                     ms=device_ms(lambda: li.slab_row_partials(f, slab)),
                     adjoint_ms=device_ms(lambda: li.los_integrate_adjoint(ybar, t)),
                     plain_ms=cuda_ms(lambda: li.slab_row_partials_plain(f, slab), n=5),
                     adjoint_plain_ms=cuda_ms(lambda: li.slab_adjoint_plain(ybar, slab), n=5),
                     library_ms=device_ms(lib_fwd, n=10), library_events_ms=cuda_ms(lib_fwd, n=5),
                     adjoint_library_ms=cuda_ms(lib_adj, n=5),
                     adjoint_bound_ms=1e3 * (t.n_valid * (4 + size) + t.nrays * size
                                             + (t.nrays + t.ncells) * size) / PEAK_BYTES_PER_S)
            r["bound_ms"], r["bound_by"] = slab_bound_ms(slab, 1, size)
            out[slab.key, 1] = r
            print(f"{grid} slab rows {rows[0]}-{rows[1] - 1}: {t.nrays} rays ({t.n_valid} entries "
                  f"in the slab, {t.n_touched} cells touched), {slab.n_virtual} virtual rays "
                  f"(ray, row) by lanes {slab.groups} in {slab.n_blocks} blocks, compact tables "
                  f"{slab.table_bytes} B ({slab_function_bytes(slab, size)} B of the entries' cells "
                  f"and weights and the rays' scales, which the bound counts; "
                  f"{slab.table_bytes - slab_function_bytes(slab, size)} B of the layout's "
                  f"offsets, places, descriptors, mask and scales a virtual ray, which it does "
                  f"not) | float64 ms: "
                  f"los_slab_forward {r['ms']:.5f} ({100 * r['bound_ms'] / r['ms']:.1f} % of its "
                  f"bound {r['bound_ms']:.5f}, {r['bound_by']}; plain {r['plain_ms']:.4f}, "
                  f"torch.sparse.mm {r['library_ms']:.5f}, events around 5 calls "
                  f"{r['library_events_ms']:.4f}) | adjoint {r['adjoint_ms']:.5f} (bound "
                  f"{r['adjoint_bound_ms']:.5f}; plain {r['adjoint_plain_ms']:.4f}, "
                  f"torch.sparse.mm of the transpose {r['adjoint_library_ms']:.4f}) | rel err of "
                  f"sum|term| f64 {rel:.2e} / {adj_rel:.2e}", flush=True)
    for sname, got in digests.items():
        want = LOS_SLAB_PINNED[sname].split()
        if got != want:
            raise AssertionError(f"los_slab_forward {sname} bits moved from the nine-launch "
                                 f"route's pinned digests: {got} (pinned {want})")
        print(f"los_slab_forward {sname}: the nine-launch route's bits at all {len(got)} slabs "
              f"and row counts", flush=True)
    return out


def grid_text(dims):
    """`256^3` for a cube, `128x256x256` otherwise."""
    dims = tuple(dims)
    return f"{dims[0]}^{len(dims)}" if len(set(dims)) == 1 else "x".join(map(str, dims))


def los_kernel_entries(kres, runs, dtype="float64"):
    """The `kernels` line's entries of K11 and its adjoint: one for each
    direction, table and number of rows that the runs ({run: K11 counts})
    launched, with phase 25's numbers; fails on a shape that phase 25 did
    not check."""
    entries = []
    for kind, name in (("forward", "los_integrate"), ("adjoint", "los_integrate_adjoint")):
        by_run = {run: c[kind] for run, c in runs.items()}
        for shape in sorted(set().union(*by_run.values())):
            key = shape if dtype == "float64" else shape + (dtype,)
            if key not in kres:
                raise AssertionError(f"the main path launched {name} at {key}, a shape that "
                                     f"phase 25 did not hold against the plain version and time")
            r = kres[key]
            (dims, nrays, nent), nrows = shape
            entries.append(dict(
                name=f"{name} (K11, {grid_text(dims)} x {nrays} rays x {nent} entries "
                     f"B={nrows}, {dtype})",
                route="cuda", source="nifty_tpu_torch/csrc/los_interp.cu",
                replaces="nifty_tpu/responses/los.py:39 (XLA in the JAX package, not Pallas)",
                launches=next(c[shape] for c in by_run.values() if c.get(shape)),
                launches_by_run={run: c.get(shape, 0) for run, c in by_run.items()},
                max_abs_err=r[f"{kind}_err"], ms=r[f"{kind}_device_ms"],
                plain_ms=r[f"{kind}_plain_ms"], bound_ms=r[f"{kind}_bound_ms"],
                bound_by=r[f"{kind}_bound_by"], library_ms=r[f"{kind}_library_ms"],
            ))
    return entries


def los_slab_entries(sres, runs):
    """The `kernels` line's entries of `los_slab_forward`: one for each slab
    and number of rows that the runs ({run: slab counts}) launched, with
    phase 25's numbers; fails on a slab that phase 25 did not check."""
    entries = []
    for shape in sorted(set().union(*runs.values())):
        if shape not in sres:
            raise AssertionError(f"the main path launched los_slab_forward at {shape}, a slab "
                                 f"that phase 25 did not hold against the plain version")
        r = sres[shape]
        (grid, rows, nrays), nrows = shape
        entries.append(dict(
            name=f"los_slab_forward (K11 on a slab, {grid_text(grid)} rows {rows[0]}-{rows[1] - 1}"
                 f" x {nrays} rays, the (ray, row) partials B={nrows}, float64)",
            route="cuda", source="nifty_tpu_torch/csrc/los_interp.cu",
            replaces="nifty_tpu/responses/los.py:39 (XLA in the JAX package, not Pallas)",
            launches=next(c[shape] for c in runs.values() if c.get(shape)),
            launches_by_run={run: c.get(shape, 0) for run, c in runs.items()},
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
    return entries


def reset_counts():
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops import los_interp as li
    from nifty_tpu_torch.ops import nufft_window as nw

    bg.reset_launch_counts()
    li.reset_launch_counts()
    nw.reset_launch_counts()


@phase("26 demos/1_tomography.py main(): 64^3, 128 rays x 128 points, optimize_kl, 5 iterations")
def phase_demo1(jt, lh, cf):
    """`demos/1_tomography.py`'s `main()` as written: `optimize_kl` with 5
    iterations of 4 pairs, `linear_resample`, draw CG 60, KL 15 x `xtol`
    1e-4, `odir` in a temporary directory, the maps left at "auto".  The
    check: the mean reduced chi^2 of the normalized data residual in [0.5,
    2] and the posterior mean of exp(cf) finite everywhere; fails unless
    K11, K11^T and both distributor kernels launched."""
    from nifty_tpu_torch.ops import bin_gather as bg

    k_init, k_opt = jt.HostKey(DEMO1_SEED).split(2)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    marks = [time.perf_counter()]

    def clock(samples, state):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    with tempfile.TemporaryDirectory() as odir:
        samples, state = jt.optimize_kl(
            lh, jt.random_like(k_init, lh.domain), key=k_opt, n_total_iterations=5,
            n_samples=4, draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=60)),
            kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=15)),
            sample_mode="linear_resample", odir=odir, callback=clock)
    counts, k11 = launch_counts(bg), los_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        post_mean = torch.stack([torch.exp(cf(s)) for s in samples]).mean(0)
    chi2 = reduced_chi2(lh, samples)
    _, table = jt.minisanity(samples, lh.normalized_residual)
    seconds = [b - a for a, b in zip(marks, marks[1:])]
    energy = float(state.minimization_state.fun)
    print(f"demo 1 optimize_kl (64^3, 128 rays x 128 points): s/iteration "
          f"{[round(x, 3) for x in seconds]} ({sum(seconds):.3f} s) | KL energy {energy!r} | "
          f"reduced chi^2 {chi2:.4f} | post-mean cube {tuple(post_mean.shape)} | peak mem "
          f"{peak:.2f} GiB | {len(samples)} samples | K11 calls: {los_text(k11)} | "
          f"distributor calls by rows: {rows_text(counts)}\n{table}", flush=True)
    if not bool(torch.isfinite(post_mean).all()):
        raise AssertionError("demo 1: the posterior mean of exp(cf) is not finite everywhere")
    if not 0.5 <= chi2 <= 2.0:
        raise AssertionError(f"demo 1: reduced chi^2 {chi2} outside [0.5, 2]")
    require_los_launches("demo 1", k11)
    require_launches("demo 1", counts, (cf.dist,))
    return counts, k11


@phase("27 demos/1_tomography.py main_at_scale(): 256^3 n_bins=128, 1024 rays x 256 points, "
       "3 iterations")
def phase_tomography_256(jt, lh, cf, with_profile):
    """`main_at_scale()` at its full width: `OptimizeVI` with the sample loop
    for both stages, 2 samples, `nonlinear_resample` at the demo's budgets
    (`TOMO256_KWARGS`), from 0.1 times a latent draw, 3 updates.  Prints
    each iteration's seconds, samples/s, KL energy, reduced chi^2 and peak
    device memory.  The check: every latent finite and the reduced chi^2
    in [0.5, 3]; fails unless all four kernels launched.  Returns the
    counts, the first update's KL energy (phase 44's yardstick) and its
    :func:`reference` (phase 46's)."""
    from nifty_tpu_torch.ops import bin_gather as bg

    opt = jt.OptimizeVI(lh, n_total_iterations=3, residual_map="smap", kl_map="smap")
    state, pos = tomography_256_start(jt, opt, lh)
    samples = jt.Samples(pos=pos, samples=None, keys=None)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    base = torch.cuda.memory_allocated()
    seconds, energies = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, state = opt.update(samples, state)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        chi2 = reduced_chi2(lh, samples)
        energies.append(float(state.minimization_state.fun))
        if i == 0:
            ref = reference(energies[0], base, seconds[0])
        print(f"256^3 iteration {i + 1}: {seconds[-1]:.3f} s | geoVI samples/s "
              f"{2 * 2 / seconds[-1]:.4f} | KL energy {float(state.minimization_state.fun)!r} | "
              f"reduced chi^2 {chi2:.4f} | peak mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    counts, k11 = launch_counts(bg), los_counts()
    print(f"256^3: {len(samples)} samples | K11 calls: {los_text(k11)} | distributor calls by "
          f"rows: {rows_text(counts)}", flush=True)
    finite = all(bool(torch.isfinite(leaf).all()) for s in samples for leaf in s.values())
    if not finite:
        raise AssertionError("256^3: a latent is not finite")
    if not 0.5 <= chi2 <= 3.0:
        raise AssertionError(f"256^3: reduced chi^2 {chi2} outside [0.5, 3]")
    require_los_launches("256^3", k11)
    require_launches("256^3", counts, (cf.dist,))
    if with_profile:
        profile_window("256^3 tomography", lambda: kl_text(opt.update(samples, state)))
    return counts, k11, energies[0], ref


def tomography_256_start(jt, opt, lh, wide=False):
    """Phase 27's state (`TOMO256_KWARGS`) and start (0.1 times a latent
    draw), both from `DEMO1_SEED + 1` on the host: the start of phase 44's
    worlds too.  `wide`: the keys' float64 draws rounded (`WideKey`), phase
    46's float32 start."""
    k_state, k_pos = jt.HostKey(DEMO1_SEED + 1).split(2)
    if wide:
        k_state, k_pos = WideKey(jt, k_state), WideKey(jt, k_pos)
    state = opt.init_state(k_state, **TOMO256_KWARGS)
    return state, {k: 0.1 * v for k, v in jt.random_like(k_pos, lh.domain).items()}


@phase("28 the NUTS cross-check of tests/test_tomography_3d.py: 16^3, geoVI then NUTS")
def phase_nuts(jt, lh, cf):
    """`tests/test_tomography_3d.py`'s cross-check as written: geoVI
    (`optimize_kl`, 4 iterations of 4 pairs, `nonlinear_resample`), then
    `NUTSChain` on the same log-probability lh(x) + |x|^2 / 2 with step 0.02,
    depth 8, `NUTS_TRANSITIONS` transitions from the geoVI mean, the last
    half kept.  The check: fewer than 5 % of the voxels' posterior means
    differ by more than 3 (geoVI std + NUTS std + 1e-3).  Prints
    s/transition, the mean depth, the acceptance and the divergences.
    Returns the launch counts of the geoVI run and of the chain, and the
    geoVI position, its posterior mean and std and the chain's
    :func:`reference` (its mean potential over the kept half: phase 46's)."""
    from nifty_tpu_torch.ops import bin_gather as bg

    reset_counts()
    samples, _ = jt.optimize_kl(
        lh, jt.random_like(jt.HostKey(1), lh.domain), key=jt.HostKey(11),
        n_total_iterations=4, n_samples=4, draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=40)),
        nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
            xtol=1e-4, maxiter=4, cg_kwargs=dict(maxiter=20))),
        kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-5, maxiter=8, cg_kwargs=dict(maxiter=30))),
        sample_mode="nonlinear_resample")
    geo = launch_counts(bg), los_counts()
    with torch.no_grad():
        cf_geo = torch.stack([cf(s) for s in samples])
    geo_mean, geo_std = cf_geo.mean(0), cf_geo.std(0, correction=0)

    def ham(x):
        return lh(x) + 0.5 * jt.vdot(x, x)

    chain = jt.NUTSChain(potential_energy=ham, inverse_mass_matrix=1.0,
                         position_proto=samples.pos, step_size=0.02, max_tree_depth=8)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    nuts, _ = chain.generate_n_samples(42, samples.pos, NUTS_TRANSITIONS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ref = reference(mean_potential(ham, nuts), base, seconds)
    nuts_counts = launch_counts(bg), los_counts()
    keep = range(NUTS_TRANSITIONS // 2, NUTS_TRANSITIONS)
    with torch.no_grad():
        cf_nuts = torch.stack([cf({k: v[i] for k, v in nuts.samples.items()}) for i in keep])
    spread = geo_std + cf_nuts.std(0, correction=0) + 1e-3
    frac_off = float(((geo_mean - cf_nuts.mean(0)).abs() > 3.0 * spread).double().mean())
    leaves = int((2 ** nuts.depths - 1).sum())
    print(f"NUTS cross-check (16^3, 48 rays): {NUTS_TRANSITIONS} transitions in {seconds:.3f} s "
          f"({seconds / NUTS_TRANSITIONS:.4f} s/transition, {leaves} leapfrog leaves, "
          f"{1e3 * seconds / max(leaves, 1):.3f} ms a leaf) | mean depth "
          f"{float(nuts.depths.double().mean()):.3f} | acceptance "
          f"{float(nuts.acceptance.mean()):.4f} | divergences {int(nuts.divergences.sum())} | "
          f"voxels off {frac_off:.4f} | mean geoVI std {float(geo_std.mean()):.4f}, NUTS std "
          f"{float(cf_nuts.std(0, correction=0).mean()):.4f} | K11 calls: geoVI "
          f"{los_text(geo[1])}; NUTS {los_text(nuts_counts[1])}", flush=True)
    for label, (counts, k11) in (("NUTS cross-check geoVI", geo), ("NUTS chain", nuts_counts)):
        require_los_launches(label, k11)
        require_launches(label, counts, (cf.dist,))
    if not frac_off < 0.05:
        raise AssertionError(f"NUTS and geoVI disagree on {frac_off:.4f} of the voxels")
    return geo, nuts_counts, (samples.pos, geo_mean, geo_std, ref)


# -- inference and diagnostics (phases 29-33) --------------------------------

# phase 33's probes (the same for the 4096^2 run and both 128^2 runs)
EVIDENCE_PROBES = 33


@phase("29 demos/5_wiener_filter.py: 256^2, a 70 % mask, noise 0.1, CG preconditioned by S")
def phase_demo5(jt):
    """`demos/5_wiener_filter.py` as written: a known-covariance Gaussian
    signal on 256^2 seen through a 70 % mask with noise 0.1, the posterior
    mean by CG on the Wiener-filter curvature (`resnorm` 1e-4, at most 500
    steps, preconditioned by S) and a posterior sample by the metric-sample
    construction.  The demo's check: relative reconstruction error below
    0.5.  Prints both CG infos and the sample's std about the mean."""
    dims, noise_std = (256, 256), 0.1
    dev = jt.config.default_device()
    ops = demo5_operators(dims, dev)
    key = jt.HostKey(42)
    key, sub = jt.split(key, 2)
    like = jt.ShapeWithDtype(dims)
    mask = jt.random_like(sub, like, rng=uniform, device=dev) > 0.3  # keep ~70%

    def R(s):
        return torch.where(mask, s, 0.0)

    def N_inv(d):
        return d / noise_std ** 2

    def N_inv_sqrt(xi):
        return xi / noise_std

    key, sub = jt.split(key, 2)
    s_truth = ops["S_sqrt"](jt.random_like(sub, like, device=dev))
    key, sub = jt.split(key, 2)
    data = R(s_truth) + noise_std * jt.random_like(sub, like, device=dev) * mask
    proto = torch.zeros(dims, dtype=torch.float64, device=dev)
    cg = dict(resnorm=1e-4, maxiter=500, preconditioner=ops["S_apply"])
    synchronize(jt)
    t0 = time.perf_counter()
    m, info = jt.wiener_filter(data, R, N_inv, ops["S_inv"], domain_proto=proto, cg_kwargs=cg)
    err = float(torch.sqrt(torch.mean((m - s_truth) ** 2) / torch.mean(s_truth ** 2)))
    t1 = time.perf_counter()
    key, sub = jt.split(key, 2)
    samp, sinfo = jt.draw_posterior_sample(
        sub, R, N_inv, ops["S_inv"], ops["S_sqrt"], N_inv_sqrt, domain_proto=proto,
        data_proto=proto, mean=m, S_inv_sqrt=ops["S_inv_sqrt"], cg_kwargs=cg)
    std = float(torch.std(samp - m))
    t2 = time.perf_counter()
    print(f"demo 5 (256^2): posterior mean CG info {info} in {t1 - t0:.3f} s | relative "
          f"reconstruction error {err:.4f} | posterior sample CG info {sinfo} in {t2 - t1:.3f} s, "
          f"std about the mean {std:.5f}", flush=True)
    if not err < 0.5:
        raise AssertionError(f"demo 5: relative reconstruction error {err} is not below 0.5")


def banana_likelihood(jt):
    """`demos/8_parametric_vi.py`'s banana: d = x0 + x1^2 = 1, noise 0.2."""

    def fwd(x):
        return (x["x0"] + x["x1"] ** 2)[None]

    data = torch.tensor([1.0], dtype=torch.float64, device=jt.config.default_device())
    lh = jt.Gaussian(data, noise_std_inv=lambda x: x / 0.2).amend(
        jt.Model(fwd, domain={"x0": jt.ShapeWithDtype(()), "x1": jt.ShapeWithDtype(())}))
    return lh, fwd


def timed_vi(jt, vi, key, n_steps):
    """`vi.run(key, n_steps)` and its ms per optimizer step."""
    synchronize(jt)
    t0 = time.perf_counter()
    params, losses = vi.run(key, n_steps=n_steps)
    synchronize(jt)
    return params, losses, 1e3 * (time.perf_counter() - t0) / n_steps


@phase("30 demos/8_parametric_vi.py: the banana, MeanFieldVI and FullCovarianceVI, 600 Adam "
       "steps each")
def phase_demo8(jt):
    """`demos/8_parametric_vi.py` as written: 600 Adam steps of each family
    with 8 mirrored samples, then 512 samples of each.  The demo's checks:
    |corr_MF| < 0.35, |corr_FC| > |corr_MF| and the predictive mean within
    0.3 of 1.  Prints ms per Adam step."""
    lh, fwd = banana_likelihood(jt)
    k_mf, k_fc = jt.HostKey(0).split(2)
    mf = jt.MeanFieldVI(lh, n_samples=8)
    mf_params, mf_losses, mf_ms = timed_vi(jt, mf, k_mf, 600)
    fc = jt.FullCovarianceVI(lh, n_samples=8)
    fc_params, fc_losses, fc_ms = timed_vi(jt, fc, k_fc, 600)
    ks = jt.HostKey(1).split(512)
    mf_s = jt.stack([mf.sample(mf_params, k) for k in ks])
    fc_s = jt.stack([fc.sample(fc_params, k) for k in ks])

    def corr(s):
        return float(np.corrcoef(s["x0"].cpu().numpy(), s["x1"].cpu().numpy())[0, 1])

    c_mf, c_fc = corr(mf_s), corr(fc_s)
    with torch.no_grad():
        pred = float(torch.stack([fwd(fc.sample(fc_params, k)) for k in ks]).mean())
    print(f"demo 8: final losses mean-field {float(mf_losses[-1]):.3f}, full-cov "
          f"{float(fc_losses[-1]):.3f} | ms per Adam step mean-field {mf_ms:.3f}, full-cov "
          f"{fc_ms:.3f} | x0-x1 sample correlation mean-field {c_mf:+.3f}, full-cov {c_fc:+.3f} "
          f"| posterior predictive mean {pred:.4f} (data 1.0)", flush=True)
    if not (abs(c_mf) < 0.35 and abs(c_fc) > abs(c_mf) and abs(pred - 1.0) < 0.3):
        raise AssertionError(f"demo 8's checks failed: corr MF {c_mf}, FC {c_fc}, predictive "
                             f"mean {pred}")


DEMO15_SCALE, DEMO15_SLOPE = 10.0, 1.35


def demo15_density():
    """`demos/15_vi_visualized.py`'s grid of the exact posterior over (a, b):
    the grid's axes and the normalized density on it."""
    grid_a, grid_b = np.linspace(-0.9, 0.9, 401), np.linspace(-4.5, 4.5, 401)
    aa, bb = np.meshgrid(grid_a, grid_b, indexing="ij")
    lh = 0.5 * (DEMO15_SCALE * aa) ** 2 * np.exp(-2 * DEMO15_SLOPE * bb) + DEMO15_SLOPE * bb
    z = np.exp(-(lh + 0.5 * (aa ** 2 + bb ** 2)))
    return grid_a, grid_b, z / z.sum()


def demo15_moments():
    """The grid quadrature of `demo15_density`: means and standard
    deviations."""
    grid_a, grid_b, z = demo15_density()
    aa, bb = np.meshgrid(grid_a, grid_b, indexing="ij")
    ma, mb = (aa * z).sum(), (bb * z).sum()
    return ma, mb, np.sqrt(((aa - ma) ** 2 * z).sum()), np.sqrt(((bb - mb) ** 2 * z).sum())


@phase("31 demos/15_vi_visualized.py: MGVI and geoVI (15 iterations of 20 samples), MFVI and "
       "FCVI (2000 steps)")
def phase_demo15(jt):
    """`demos/15_vi_visualized.py` as written: a datum 0 of mean 10 a and
    inverse std exp(-1.35 b); MGVI (`linear_resample`) and geoVI
    (`nonlinear_resample`) through `optimize_kl` with 15 iterations of 20
    samples at the demo's budgets, then 2000 steps each of `MeanFieldVI`
    and `FullCovarianceVI` with 8 samples and 200 draws each.  The demo's
    check: each flavour's sample mean within 3 std of the grid-quadrature
    moments.  Draws the demo's figure (each flavour's samples over the
    exact density's contours)."""

    def forward(x):
        return (DEMO15_SCALE * x["a"], torch.exp(-DEMO15_SLOPE * x["b"]))

    dev = jt.config.default_device()
    lh = jt.VariableCovarianceGaussian(torch.zeros((), dtype=torch.float64, device=dev)).amend(
        jt.Model(forward, domain={"a": jt.ShapeWithDtype(()), "b": jt.ShapeWithDtype(())},
                 white_init=True))
    ma, mb, sa, sb = demo15_moments()
    key = jt.HostKey(3)
    clouds, seconds = {}, {}
    for label, mode in (("MGVI", "linear_resample"), ("geoVI", "nonlinear_resample")):
        key, ik, ok = jt.split(key, 3)
        t0 = time.perf_counter()
        samples, _ = jt.optimize_kl(
            lh, jt.random_like(ik, lh.domain), key=ok, n_total_iterations=15, n_samples=20,
            sample_mode=mode, draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=30)),
            nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
                xtol=1e-4, maxiter=10, cg_kwargs=dict(maxiter=20))),
            kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-5, maxiter=15, cg_kwargs=dict(maxiter=20))),
            odir=None, plot_energy_history=False)
        seconds[label] = time.perf_counter() - t0
        s = samples.samples
        clouds[label] = np.stack([s["a"].cpu().numpy(), s["b"].cpu().numpy()], -1)
    key, k1, k2, k3, k4 = jt.split(key, 5)
    for label, cls, k_run, k_draw in (("MFVI", jt.MeanFieldVI, k1, k2),
                                      ("FCVI", jt.FullCovarianceVI, k3, k4)):
        vi = cls(lh, n_samples=8)
        params, _, ms = timed_vi(jt, vi, k_run, 2000)
        seconds[label] = 2000 * ms / 1e3
        draws = jt.stack([vi.sample(params, k) for k in jt.split(k_draw, 200)])
        clouds[label] = np.stack([draws["a"].cpu().numpy(), draws["b"].cpu().numpy()], -1)
    print(f"demo 15: exact a = {ma:+.4f} ± {sa:.4f}, b = {mb:+.4f} ± {sb:.4f}", flush=True)
    failed = []
    for label, pts in clouds.items():
        ea, eb = pts[:, 0].mean(), pts[:, 1].mean()
        print(f"demo 15 {label:<5}: a = {ea:+.4f} ± {pts[:, 0].std():.4f}, b = {eb:+.4f} ± "
              f"{pts[:, 1].std():.4f} | {len(pts)} samples in {seconds[label]:.3f} s", flush=True)
        if not (abs(ea - ma) < 3 * sa and abs(eb - mb) < 3 * sb):
            failed.append(label)

    def figure(d):
        import matplotlib.pyplot as plt

        grid_a, grid_b, z = demo15_density()
        fig, axs = plt.subplots(2, 2, figsize=(9, 8), sharex=True, sharey=True)
        for ax, (label, pts) in zip(axs.ravel(), clouds.items()):
            ax.contour(grid_a, grid_b, z.T, levels=8, linewidths=0.6)
            ax.scatter(pts[:, 0], pts[:, 1], s=6, alpha=0.6, c="crimson")
            ax.set_title(label)
            ax.set_xlabel("a")
            ax.set_ylabel("b")
        fig.tight_layout()
        path = os.path.join(d, "vi_visualized.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return [path]

    write_figures("demo 15", figure)
    if failed:
        raise AssertionError(f"demo 15: {failed} outside 3 std of the exact moments")


def demo11_field(jt, flexibility, prefix):
    """`demos/11_model_comparison.py`'s `build_cf`: a 64^2 correlated field,
    flexible (the generative model) or a rigid fixed-slope power law."""
    dims = (64, 64)
    cfm = jt.CorrelatedFieldMaker(prefix)
    cfm.set_amplitude_total_offset(offset_mean=0.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(
        dims, distances=1.0 / dims[0], fluctuations=(1.0, 5e-1),
        loglogavgslope=(-3.5, 2e-1) if flexibility else (-6.0, 1e-2),
        flexibility=(1.0, 5e-1) if flexibility else None,
        asperity=(5e-1, 1e-1) if flexibility else None,
    )
    return cfm.finalize()


@phase("32 demos/11_model_comparison.py: two 64^2 fields, optimize_kl 5 x 2, ELBO by ARPACK")
def phase_demo11(jt):
    """`demos/11_model_comparison.py` as written: data from the flexible
    64^2 field plus noise 0.1; a flexible and a rigid model each fitted by
    `optimize_kl` (5 iterations of 2 samples, `nonlinear_resample`, `odir`
    in a temporary directory), then `estimate_evidence_lower_bound` with 40
    eigenvalues (ARPACK with deflation).  The demo's check: the evidence
    prefers the flexible model.  Prints both ELBO intervals, the ARPACK
    matvecs and their seconds; fails unless both distributor kernels
    launched.  Returns the launch counts and the map."""
    from nifty_tpu_torch.ops import bin_gather as bg

    noise_std = 0.1
    bg.reset_launch_counts()
    key = jt.HostKey(21)
    truth_model = demo11_field(jt, True, "true")
    key, sk = jt.split(key, 2)
    with torch.no_grad():
        truth = truth_model(truth_model.init(sk))
    key, sk = jt.split(key, 2)
    data = truth + noise_std * jt.random_like(sk, truth)
    results, lines = {}, []
    with tempfile.TemporaryDirectory() as odir:
        for name, flex in (("flexible", True), ("rigid", False)):
            cf = demo11_field(jt, flex, name)
            lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std ** 2).amend(cf)
            key, sk = jt.split(key, 2)
            _, ko, ki = jt.split(sk, 3)
            synchronize(jt)
            t0 = time.perf_counter()
            samples, _ = jt.optimize_kl(
                lh, jt.random_like(ki, lh.domain), key=ko, n_total_iterations=5, n_samples=2,
                draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=64)),
                nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
                    xtol=1e-3, maxiter=5, cg_kwargs=dict(maxiter=24))),
                kl_kwargs=dict(minimize_kwargs=dict(
                    xtol=1e-4, maxiter=10, cg_kwargs=dict(maxiter=32))),
                sample_mode="nonlinear_resample", odir=os.path.join(odir, name))
            synchronize(jt)
            t1 = time.perf_counter()
            _, stats = jt.estimate_evidence_lower_bound(lh, samples, n_eigenvalues=40,
                                                        verbose=False)
            stats = {k: float(v) for k, v in stats.items()}
            synchronize(jt)
            t2 = time.perf_counter()
            results[name] = stats
            lines.append(
                f"{name}: ELBO in [{stats['elbo_lw']:.1f}, {stats['elbo_up']:.1f}] (mean "
                f"{stats['elbo_mean']!r}, lower error {stats['lower_error']:.3f}) | fit "
                f"{t1 - t0:.3f} s | ARPACK {stats['metric_matvecs']:.0f} matvecs in "
                f"{t2 - t1:.3f} s | largest eigenvalue {stats['largest_eigenvalue']!r}")
    counts = launch_counts(bg)
    better = max(results, key=lambda k: results[k]["elbo_mean"])
    print("demo 11: " + " | ".join(lines) + f" | preferred: {better} | distributor calls by "
          f"rows: {rows_text(counts)}", flush=True)
    require_launches("demo 11", counts, (cf.dist,))
    if better != "flexible":
        raise AssertionError("demo 11: the ELBO should prefer the generative model")
    return counts, cf.dist


@phase("33 the evidence at full width: SLQ on phase 6's 4096^2 posterior (16.8 M dof, 8 probes of "
       "30 steps, looped), and on phase 5's 128^2 posterior in lockstep and looped")
def phase_evidence(jt, lh4096, samples4096, lh128, samples128, with_profile):
    """`estimate_evidence_lower_bound(method="slq")` at the JAX package's
    defaults (`slq_order=30`, `slq_samples=8`) on phase 6's posterior (the
    4096^2 `n_bins=128` field and its 8 samples), the probes looped (one
    probe's Krylov block is 30 x 16.8 M x 8 B = 4.0 GB).  The checks: 0 <=
    log det <= n log(largest Ritz value), `elbo_lw <= elbo_mean <= elbo_up`,
    every number finite.  Prints the seconds, the metric matvecs and the
    peak device memory.  Then on phase 5's 128^2 posterior, the same
    `HostKey` probes as lockstep rows and looped: log-determinants within
    1e-10 relative.  Fails unless both distributor kernels launched in each
    part.  Returns both parts' launch counts."""
    from nifty_tpu_torch.ops import bin_gather as bg

    kw = dict(n_eigenvalues=0, method="slq", key=jt.HostKey(EVIDENCE_PROBES), verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bg.reset_launch_counts()
    t0 = time.perf_counter()
    elbo, stats = jt.estimate_evidence_lower_bound(lh4096, samples4096, slq_map="smap", **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = {k: float(v) for k, v in stats.items()}
    c4096 = launch_counts(bg)
    n = jt.tree.size(samples4096.pos)
    values = [*elbo, *(stats[k] for k in ("elbo_mean", "elbo_up", "elbo_lw", "logdet",
                                          "largest_eigenvalue"))]
    matvecs = stats["metric_matvecs"]
    print(f"evidence 4096^2 n_bins=128 ({n} dof, {len(samples4096)} samples): SLQ in "
          f"{seconds:.3f} s, {matvecs:.0f} metric matvecs ({1e3 * seconds / matvecs:.2f} ms "
          f"each, reorthogonalization included) | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | log det {stats['logdet']!r}, "
          f"largest Ritz value {stats['largest_eigenvalue']!r} | ELBO mean {stats['elbo_mean']!r} "
          f"in [{stats['elbo_lw']!r}, {stats['elbo_up']!r}] | distributor calls by rows: "
          f"{rows_text(c4096)}", flush=True)
    if not all(np.isfinite(v) for v in values):
        raise AssertionError(f"evidence 4096^2: a number is not finite: {values}")
    if not 0.0 <= stats["logdet"] <= n * np.log(stats["largest_eigenvalue"]):
        raise AssertionError(f"evidence 4096^2: log det {stats['logdet']} outside [0, n log "
                             f"{stats['largest_eigenvalue']}]")
    if not stats["elbo_lw"] <= stats["elbo_mean"] <= stats["elbo_up"]:
        raise AssertionError(f"evidence 4096^2: ELBO interval out of order: {stats}")
    require_launches("evidence 4096^2", c4096)
    if with_profile:
        profile_window("evidence 4096^2, one SLQ probe", lambda: "log det {!r}".format(
            jt.estimate_evidence_lower_bound(lh4096, samples4096, slq_map="smap",
                                             slq_samples=1, **kw)[1]["logdet"]))

    bg.reset_launch_counts()
    logdets, secs = {}, {}
    for slq_map in ("vmap", "smap"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, st = jt.estimate_evidence_lower_bound(lh128, samples128, slq_map=slq_map, **kw)
        torch.cuda.synchronize()
        secs[slq_map], logdets[slq_map] = time.perf_counter() - t0, st["logdet"]
    c128 = launch_counts(bg)
    rel = abs(logdets["vmap"] - logdets["smap"]) / abs(logdets["smap"])
    print(f"evidence 128^2: log det in lockstep rows {logdets['vmap']!r} ({secs['vmap']:.3f} s), "
          f"looped {logdets['smap']!r} ({secs['smap']:.3f} s), relative difference {rel:.3e} | "
          f"distributor calls by rows: {rows_text(c128)}", flush=True)
    if not rel <= 1e-10:
        raise AssertionError(f"evidence 128^2: lockstep and looped log det differ by {rel:.3e}")
    require_launches("evidence 128^2", c128)
    return c4096, c128


K7_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# phase 35's seeds: the sky (and the 32^2 radio case of phase 4), the noise,
# the state and the start
RADIO_SEED = 35


def earth_rotation_uvw(n_steps, hours=4.0, lat_deg=34.0, dec_deg=45.0, arm_km=21.0,
                       wavelength=0.21):
    """Earth-rotation synthesis of a Y-shaped array in the manner of the
    VLA's A configuration: 27 antennas, nine an arm on three arms at
    azimuths 5, 125 and 245 degrees, at radii ``arm_km (n / 9)^1.716``
    (the VLA's power-law spacing), observing at latitude `lat_deg` a source
    at declination `dec_deg` over hour angles -`hours` to +`hours` in
    `n_steps` steps, at `wavelength` metres (21 cm).  Returns (u, v) and w
    of the 351 baselines at every step, in wavelengths (``(351 n_steps,
    2)`` and ``(351 n_steps,)``, step-major), by the standard rotation of
    the baselines' equatorial (X, Y, Z) coordinates."""
    az = np.deg2rad([5.0, 125.0, 245.0])
    radii = arm_km * 1e3 * (np.arange(1, 10) / 9.0) ** 1.716
    east = (radii[None, :] * np.sin(az[:, None])).ravel()
    north = (radii[None, :] * np.cos(az[:, None])).ravel()
    lat = np.deg2rad(lat_deg)
    x, y, z = -np.sin(lat) * north, east, np.cos(lat) * north
    i, j = np.triu_indices(east.size, 1)
    bx, by, bz = x[j] - x[i], y[j] - y[i], z[j] - z[i]
    h = np.deg2rad(15.0 * np.linspace(-hours, hours, n_steps))[:, None]
    dec = np.deg2rad(dec_deg)
    u = np.sin(h) * bx + np.cos(h) * by
    v = -np.sin(dec) * np.cos(h) * bx + np.sin(dec) * np.sin(h) * by + np.cos(dec) * bz
    w = np.cos(dec) * np.cos(h) * bx - np.cos(dec) * np.sin(h) * by + np.sin(dec) * bz
    return np.stack([u.ravel(), v.ravel()], axis=-1) / wavelength, w.ravel() / wavelength


def radio_response(shape, n_steps, n_vis=None):
    """The w-stacked `RadioResponse` (8 planes, sigma 2, W 8) of the first
    `n_vis` of `earth_rotation_uvw(n_steps)`'s visibilities, the pixel size
    putting the longest baseline at 0.45 of the grid's Nyquist frequency."""
    from nifty_tpu_torch.ops.nufft import RadioResponse

    uv, w = earth_rotation_uvw(n_steps)
    if n_vis is not None:
        uv, w = uv[:n_vis], w[:n_vis]
    pixsize = 0.45 * 0.5 / np.max(np.hypot(uv[:, 0], uv[:, 1]))
    return RadioResponse(shape, uv, pixsize=pixsize, w=w, n_w_planes=8)


def build_radio(jt, field, shape, n_steps, key, n_vis=None):
    """Radio imaging: the sky exp(`field`) observed by
    `radio_response(shape, n_steps, n_vis)`; data from a prior draw
    (latents drawn on the host from `key`) plus complex white noise of
    modulus rms 0.1 times the rms of the true visibilities (each part 0.1
    rms / sqrt 2), a complex `Gaussian`.  Returns the likelihood, the
    response and the per-part noise std."""
    rr = radio_response(shape, n_steps, n_vis)
    fwd = pointwise(jt, field, lambda s: rr(torch.exp(s)))
    k_truth, k_noise = jt.split(key, 2)
    with torch.no_grad():
        vis = fwd(fwd.init(k_truth))
        rms = float(torch.sqrt(torch.mean(vis.abs() ** 2)))
        data = vis + 0.1 * rms * jt.random_like(k_noise, vis)  # E|n|^2 = (0.1 rms)^2
    std = 0.1 * rms / np.sqrt(2.0)
    return jt.Gaussian(data, noise_cov_inv=lambda x: x / std ** 2).amend(fwd), rr, std


def radio_chi2(lh, pos):
    """The reduced chi^2 of the normalized residual at `pos`, two degrees of
    freedom a visibility."""
    with torch.no_grad():
        return float(torch.mean(lh.normalized_residual(pos).abs() ** 2)) / 2.0


def k7_counts():
    """K7's calls of the kernel route, by (table key, rows), and the factor
    tables it built, by table key."""
    from nifty_tpu_torch.ops import nufft_window as nw

    return {"interp": dict(nw.window_interp.launches_by_shape),
            "spread": dict(nw.window_spread.launches_by_shape),
            "factors": dict(nw.build_factors.launches_by_shape)}


def k7_text(counts):
    def table(key):
        return f"{key[0][0]}^{len(key[0])} grid x {key[1]} points"

    return " ".join(f"{kind} " + ", ".join(f"{table(key)} B={b}: {n}"
                                          for (key, b), n in sorted(counts[kind].items()))
                    for kind in ("interp", "spread")) + " factors " + ", ".join(
        f"{table(key)}: {n}" for key, n in sorted(counts["factors"].items()))


def k7_bound_ms(tab, nrows, size, spread):
    """The least time of one K7 call: the coordinates, the points' values
    and the grid (the interpolation reads the cells its windows reach; the
    spread writes every cell) read or written once each over the memory
    rate, or the window's complex-by-real multiply-adds (4 operations a tap)
    over the arithmetic rate, whichever is larger; and which of the two
    that is."""
    cells = tab.ncells if spread else tab.n_reached
    byts = nrows * (cells + tab.npts) * 2 * size + tab.npts * tab.d * size
    ops = 4 * nrows * tab.npts * tab.width ** tab.d
    by_bytes = 1e3 * byts / PEAK_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_OPS_PER_S[torch.float64]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k7_factors_bound_ms(tab, size):
    """The least time of a factor table's build: the coordinates and the
    CSR order read and the table written once each over the memory rate,
    or one exponential, square root and divide a factor (counted as 3
    operations) over the arithmetic rate, whichever is larger."""
    nfac = tab.npts * tab.d * tab.width
    by_bytes = 1e3 * (tab.npts * tab.d * size + 4 * tab.npts + nfac * size) / PEAK_BYTES_PER_S
    by_ops = 1e3 * 3 * nfac / PEAK_OPS_PER_S[torch.float64]
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def k7_library_routes(tab, g, v):
    """One PyTorch call for each direction on the same inputs, which the
    port never calls: ``torch.sparse.mm`` of the interpolation matrix (each
    point's W^d taps and weights) as a complex CSR, and of its transpose."""
    from nifty_tpu_torch.ops import nufft_window as nw

    cells, weights = nw.window_entries(tab)
    taps = cells.shape[1]
    crow = torch.arange(tab.npts + 1, device=g.device) * taps
    matrix = torch.sparse_csr_tensor(crow, cells.reshape(-1), weights.reshape(-1).to(g.dtype),
                                     (tab.npts, tab.ncells))
    transposed = matrix.to_sparse_coo().t().to_sparse_csr()
    return (lambda: torch.sparse.mm(matrix, g.T).T,
            lambda: torch.sparse.mm(transposed, v.T).T)


# The digests of the K7 kernels as first written (commit c550464's
# `nufft_window.cu`, built and run beside these on an NVIDIA H100 80GB HBM3
# at 700 W) at each phase-34 shape, in phase 34's
# order: the first 8 hex digits of the SHA-256 of the output's bytes, on the
# inputs of `k7_bit_inputs`.  Phase 34 holds the kernels to them.
K7_PINNED = {
    "f64": {
        "interp": (
            "74e2faba b0716850 f77484cb 1bbf83ec 72b6a47d e85020f0 b2c1871f 272612fc "
            "d90ab8aa 52b05e15 93fbdabc 433fbee9 4a7134f3 83f33242 4d4582d4 3502c970 "
            "eac69b35 dcc3f299 db3e52f6 49cc965f fc2fb973 a49edad3 79ced865 4e411c52 "
            "a266d2f6 9ac0f5a6 491e0168 34608242 835824df 5e65f93b 95958ed8 235206d9"),
        "spread": (
            "571f278a fce68293 1a978130 954db53e 332541e9 d7a33a8d 62292cbc fe54eb88 "
            "c45ad827 27e13aed 974a16a6 c4581b3f e7a3ceeb b0db9c83 06903842 74e65ee8 "
            "767e250f 1b5ba2db 2db9b979 c4848856 8bc2e080 e025f38f 53ae937d 4c030c52 "
            "0338d772 15a96b7c 6774143c 61647073 a01ddec5 14f8ad26 b2066d17 cd140dce"),
    },
    "f32": {
        "interp": (
            "b3c48593 54bbcde8 e9e402b5 9d5c87a8 61ecb859 04492f08 520de822 9dc1b664 "
            "e05ed3a0 2da92c58 8f76b619 22895a00 729fbab7 df55d60e 6bec06ef a4d325a9 "
            "22af4f6d 9031ee40 f5c929d2 3501acef f32de015 4b59dd08 ebd43deb c0877dcf "
            "02e4b2e8 fd6af540 bca4162d f920782a e3cc0503 54b75bc4 84c99fc6 a30b6093"),
        "spread": (
            "6db8df5c 5ef1e59a 203bf150 2b941690 be208474 88e0cc3e 65373766 7eee5a5a "
            "47c6a863 b75134e0 9706767e 6c8ecb7c e06e7d28 362ff863 77356773 4914c282 "
            "a87b9743 58a9e7ac 8388bb52 1215e862 175e54ca a9cd15a2 859d3838 3d4598f9 "
            "15c075fb 2d514650 1b92b63e a77c808d 93572a6e 90fff4d5 95a5a1aa 590cac1c"),
    },
}


def k7_bit_inputs(label, tab, nrows):
    """The bit check's spectrum and values at one phase-34 shape: standard
    normal real and imaginary parts that numpy draws in float64 from a seed
    of the shape's label (float32 rounds the same draws), on the card."""
    rng = np.random.default_rng(zlib.crc32(label.encode()))
    draws = (rng.standard_normal((nrows, tab.ncells, 2)),
             rng.standard_normal((nrows, tab.npts, 2)))
    return tuple(torch.view_as_complex(torch.from_numpy(a).to(tab.dtype)).cuda() for a in draws)


def digest(x):
    """The first 8 hex digits of the SHA-256 of a tensor's bytes."""
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:8]


def longest_lane(tab, lanes=8):
    """The most terms one lane of the spread walks in order, on a 2-D table
    (None otherwise): lane l of a cell takes its (leading tap, tap) items i
    = row W + t with i % `lanes` = l, each the points of the base cell
    (line - (row - W/2 + 1), column - (t - W/2 + 1)), wrapped."""
    if tab.d != 2:
        return None
    counts = np.diff(tab.csr_off.cpu().numpy()).reshape(tab.os_shape)
    w, lo = tab.width, tab.width // 2 - 1
    walks = np.zeros((lanes,) + counts.shape, dtype=np.int64)
    for i in range(w * w):
        row, t = divmod(i, w)
        walks[i % lanes] += np.roll(counts, (row - lo, t - lo), axis=(0, 1))
    return int(walks.max())


def k7_plane_text(tab):
    """A table's spread work: its sum blocks and their terms (the heaviest
    block's too), the longest lane's walk, and its fill chunks and their
    cells."""
    from nifty_tpu_torch.ops import nufft_window as nw

    terms = nw.spread_block_terms(nw.window_terms(
        np.diff(tab.csr_off.cpu().numpy()).reshape(tab.os_shape), tab.width))
    fill_cells = int(tab.fill[:, 1].sum()) if tab.fill.numel() else 0
    return (f"{tab.sum_blocks.numel()} sum blocks ({int(terms.sum())} terms, the heaviest "
            f"{int(terms.max())}; the longest lane walks {longest_lane(tab)}), "
            f"{tab.fill.shape[0]} fill chunks ({fill_cells} of {tab.ncells} cells)")


@phase("34 the NUFFT window kernels (K7) vs plain")
def phase_k7_kernels(cases, f32=()):
    """`cases`: {label: (RadioResponse, plane, rows)}.  K7's interpolation
    and spread against their plain versions in float64 and float32 (within
    1e-12 / 1e-5 of the per-output sum of |term|), bitwise reproducible and
    bitwise equal when replayed from a CUDA graph; the factor table within
    4 ulp of its plain version (the card's exponential and PyTorch's may
    round apart); each kernel's registers and spills (printed once);
    float64 device ms (50 calls in a replayed CUDA graph) beside the bound
    and the share of it reached, the factor table's build, the plain
    versions' and the library routes' ms (CUDA events around 5 calls); the
    bits: both kernels' outputs on `k7_bit_inputs` hashed and held to
    `K7_PINNED`, and the cells no window reaches +0 with a clear sign bit;
    each table's spread work (`k7_plane_text`, once a table, in float64).
    Returns the results by (table key, rows) and the factor tables' by
    table key; the labels in `f32` (the shapes phase 46's float32 leg
    launches) are timed in float32 too, under (table key, rows, "float32")
    and (table key, "float32")."""
    from nifty_tpu_torch.ops import nufft_window as nw

    for line in ptxas_lines("nufft_window", "nufft_interp|nufft_spread|nufft_factors|nufft_gather"):
        print(f"K7 build: {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(34)
    results, factor_results, described = {}, {}, set()
    digests = {(dt, kind): [] for dt in ("f64", "f32") for kind in ("interp", "spread")}
    for label, (rr, plane, nrows) in cases.items():
        for dtype in (torch.float64, torch.float32):
            tab = rr.plane_tables(dtype)[plane]
            cd = tab.complex_dtype
            tiny = torch.finfo(dtype).tiny
            fac = nw.build_factors(tab)
            fac_plain = nw.csr_factors_plain(tab)
            fac_ulps = float(((fac - fac_plain).abs() / fac_plain.abs().clamp_min(tiny)).max()
                             / torch.finfo(dtype).eps) if fac.numel() else 0.0
            if fac_ulps > 4:
                raise AssertionError(f"the K7 factor table is {fac_ulps:.2f} ulp off its plain "
                                     f"version ({label}, {dtype})")
            # the bits, on numpy's inputs
            gb, vb = k7_bit_inputs(label, tab, nrows)
            ab, sb = nw.window_interp(gb, tab), nw.window_spread(vb, tab)
            sname = "f64" if dtype == torch.float64 else "f32"
            for kind, out in (("interp", ab), ("spread", sb)):
                digests[sname, kind].append(digest(out))
            unreached = torch.from_numpy(nw.window_terms(
                np.diff(tab.csr_off.cpu().numpy()).reshape(tab.os_shape), tab.width
            ).reshape(-1) == 0).to(dev)
            zeros = torch.view_as_real(sb)[:, unreached]
            if bool((zeros != 0).any()) or bool(torch.signbit(zeros).any()):
                raise AssertionError(f"a cell no window reaches is not +0 ({label}, {dtype})")
            del gb, vb, ab, sb
            g = torch.randn((nrows, tab.ncells), dtype=cd, device=dev, generator=gen)
            v = torch.randn((nrows, tab.npts), dtype=cd, device=dev, generator=gen)
            a1, a2 = nw.window_interp(g, tab), nw.window_interp(g, tab)
            s1, s2 = nw.window_spread(v, tab), nw.window_spread(v, tab)
            torch.cuda.synchronize()
            if not (torch.equal(a1, a2) and torch.equal(s1, s2)):
                raise AssertionError(f"the K7 kernels do not repeat ({label}, {dtype})")
            if not (torch.equal(a1, replayed(lambda: nw.window_interp(g, tab)))
                    and torch.equal(s1, replayed(lambda: nw.window_spread(v, tab)))):
                raise AssertionError(
                    f"the K7 kernels differ when replayed from a CUDA graph ({label}, {dtype})")
            plain = nw.window_interp_plain(g, tab), nw.window_spread_plain(v, tab)
            scales = nw.sum_abs_terms(tab, g=g), nw.sum_abs_terms(tab, v=v)
            rels = [float(((got - want).abs() / scale.clamp_min(tiny)).max())
                    for got, want, scale in zip((a1, s1), plain, scales)]
            if max(rels) > K7_RTOL[dtype]:
                raise AssertionError(f"the K7 kernels are off their plain versions by {rels} "
                                     f"of the per-output sum of |term| ({label}, {dtype})")
            if dtype == torch.float32 and label not in f32:
                continue
            name = str(dtype).replace("torch.", "")
            lib_interp, lib_spread = k7_library_routes(tab, g, v)
            for got, want, scale in zip((lib_interp(), lib_spread()), plain, scales):
                if float(((got - want).abs() / scale.clamp_min(tiny)).max()) > LIBRARY_RTOL[dtype]:
                    raise AssertionError(f"a library route disagrees with the plain version "
                                         f"({label}, {dtype})")
            r = dict(interp_err=float((a1 - plain[0]).abs().max()),
                     spread_err=float((s1 - plain[1]).abs().max()),
                     interp_rel=rels[0], spread_rel=rels[1])
            r["interp_device_ms"] = device_ms(lambda: nw.window_interp(g, tab))
            r["spread_device_ms"] = device_ms(lambda: nw.window_spread(v, tab))
            r["interp_plain_ms"] = cuda_ms(lambda: nw.window_interp_plain(g, tab), n=5)
            r["spread_plain_ms"] = cuda_ms(lambda: nw.window_spread_plain(v, tab), n=5)
            r["interp_library_ms"] = cuda_ms(lib_interp, n=5)
            r["spread_library_ms"] = cuda_ms(lib_spread, n=5)
            for kind in ("interp", "spread"):
                r[f"{kind}_bound_ms"], r[f"{kind}_bound_by"] = k7_bound_ms(
                    tab, nrows, dtype.itemsize, kind == "spread")
            fkey = tab.key if dtype == torch.float64 else (tab.key, name)
            results[(tab.key, nrows) if dtype == torch.float64 else (tab.key, nrows, name)] = r
            if fkey not in factor_results:
                factor_results[fkey] = k7_factor_timing(tab, fac, fac_plain)
            f = factor_results[fkey]
            work = ""
            if dtype == torch.float64 and tab.key not in described:
                described.add(tab.key)
                work = f" | {k7_plane_text(tab)}"
            print(
                f"{label}: {tab.npts} points on the {'x'.join(map(str, tab.os_shape))} grid "
                f"({tab.n_reached} cells reached), W {tab.width}, B={nrows} | {name} ms: interp "
                f"{r['interp_device_ms']:.5f} "
                f"({100 * r['interp_bound_ms'] / r['interp_device_ms']:.1f} % of its bound "
                f"{r['interp_bound_ms']:.5f}, {r['interp_bound_by']}; plain "
                f"{r['interp_plain_ms']:.4f}, torch.sparse.mm {r['interp_library_ms']:.4f}) | "
                f"spread {r['spread_device_ms']:.5f} "
                f"({100 * r['spread_bound_ms'] / r['spread_device_ms']:.1f} % of "
                f"{r['spread_bound_ms']:.5f}, {r['spread_bound_by']}; plain (index_add_) "
                f"{r['spread_plain_ms']:.4f}, torch.sparse.mm of the transpose "
                f"{r['spread_library_ms']:.4f}) | factor table build {f['ms']:.5f} "
                f"({100 * f['bound_ms'] / f['ms']:.1f} % of {f['bound_ms']:.5f}; plain "
                f"{f['plain_ms']:.4f}; {f['ulps']:.2f} ulp) | rel err of sum|term| "
                f"{rels[0]:.2e} / {rels[1]:.2e}, max abs err {r['interp_err']:.3e} / "
                f"{r['spread_err']:.3e}{work}",
                flush=True,
            )
    labels = list(cases)
    for (sname, kind), got in digests.items():
        want = K7_PINNED[sname][kind].split()
        bad = [f"{lab}: {g} (pinned {w})" for lab, g, w in zip(labels, got, want) if g != w]
        if bad or len(want) != len(got):
            raise AssertionError(f"K7 {kind} {sname} bits moved from the pinned digests: "
                                 f"{bad or (len(want), len(got))}")
        print(f"K7 {kind} {sname}: the bits of the pinned digests at all {len(got)} shapes",
              flush=True)
    return results, factor_results


def k7_factor_timing(tab, fac, fac_plain):
    """A factor table's build: device ms of the factor kernel into a spare
    table (50 calls in a replayed CUDA graph), its bound, the plain
    version's ms (CUDA events), the largest difference in ulp (of the
    table's float type) and in absolute terms."""
    from nifty_tpu_torch.ops import nufft_window as nw

    spare = torch.empty_like(fac)
    dev = spare.get_device()
    kernel = nw._kernels()["factors", tab.dtype]

    def build():
        kernel(tab.xs.data_ptr(), tab.csr_pts.data_ptr(), spare.data_ptr(), tab.npts, tab.d,
               tab.width, tab.beta, dev, nw._stream(dev))

    ms = device_ms(build)
    torch.cuda.synchronize()
    if not torch.equal(spare, fac):
        raise AssertionError("a factor table's rebuild differs from its build")
    bound, by = k7_factors_bound_ms(tab, tab.dtype.itemsize)
    diff = (fac - fac_plain).abs()
    info = torch.finfo(tab.dtype)
    return dict(ms=ms, bound_ms=bound, bound_by=by,
                plain_ms=cuda_ms(lambda: nw.csr_factors_plain(tab), n=5),
                err=float(diff.max()),
                ulps=float((diff / fac_plain.abs().clamp_min(info.tiny)).max()) / info.eps)


def require_k7_launches(label, counts):
    if min(sum(c.values()) for c in counts.values()) <= 0:
        raise AssertionError(f"{label}: a K7 kernel never launched: {counts}")


@phase("35 radio imaging at full width: exp of a 1024^2 field, 1.0e6 visibilities in 8 "
       "w-planes, the model built and 1 update")
def phase_radio(jt, field, with_profile):
    """The 1024^2 radio model built (`build_radio`: its window tables on the
    host, its factor tables on the card at the data draw), then one
    `OptimizeVI.update` (`BENCH_KWARGS`, the sample loop for both stages)
    from 0.1 times a latent draw.  Prints the set-up's seconds, the update's
    seconds, samples/s, the KL energy, the reduced chi^2 at the start and
    after the update (at the latent mean and averaged over the samples), the
    peak device memory and K7's launches by shape.  The counts: the factor
    tables built in the set-up, and the interpolation, the spread and the
    distributor kernels launched in the update.  The checks: each of them
    launched, every latent finite, the reduced chi^2 below its start.
    Returns the distributor's and K7's counts, and the likelihood, the
    response, the noise std and the update's :func:`reference` (phase
    46's)."""
    from nifty_tpu_torch.ops import bin_gather as bg

    reset_counts()
    t0 = time.perf_counter()
    lh, rr, std = build_radio(jt, field, (1024, 1024), 2849, jt.HostKey(RADIO_SEED))
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    opt = jt.OptimizeVI(lh, n_total_iterations=100, residual_map="smap", kl_map="smap")
    k_state, k_pos = jt.HostKey(RADIO_SEED + 1).split(2)
    state = opt.init_state(k_state, **BENCH_KWARGS)
    samples = jt.Samples(pos={k: 0.1 * v for k, v in jt.random_like(k_pos, lh.domain).items()},
                         samples=None, keys=None)
    chi2_start = radio_chi2(lh, samples.pos)
    factors = k7_counts()["factors"]  # built at the data draw
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    samples, state = opt.update(samples, state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ref = reference(float(state.minimization_state.fun), base, seconds)
    counts, k7 = launch_counts(bg), dict(k7_counts(), factors=factors)
    chi2_end = radio_chi2(lh, samples.pos)
    chi2_samples = float(np.mean([radio_chi2(lh, s) for s in samples]))
    energy = float(state.minimization_state.fun)
    planes = rr.plane_tables(torch.float64)
    print(f"radio 1024^2 ({rr.target.shape[0]} visibilities, {len(planes)} w-planes of "
          f"{[t.npts for t in planes]} points on {planes[0].os_shape} grids): set-up "
          f"{setup:.3f} s | {seconds:.3f} s/update "
          f"| geoVI samples/s {2 * N_SAMPLES / seconds:.4f} | KL energy {energy!r} | reduced "
          f"chi^2 {chi2_start:.4f} at the start, {chi2_end:.4f} at the latent mean after, "
          f"{chi2_samples:.4f} over the samples | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | K7 calls: {k7_text(k7)} | "
          f"distributor calls by rows: {rows_text(counts)} | last KL Newton steps "
          f"{int(state.minimization_state.nit)}, geoVI steps per sample "
          f"{state.sample_state.nit.tolist()}", flush=True)
    finite = all(bool(torch.isfinite(leaf).all()) for s in samples for leaf in s.values())
    if not finite:
        raise AssertionError("radio 1024^2: a latent is not finite")
    if not chi2_end < chi2_start:
        raise AssertionError(f"radio 1024^2: reduced chi^2 {chi2_end} not below its start "
                             f"{chi2_start}")
    require_k7_launches("radio 1024^2", k7)
    require_launches("radio 1024^2", counts, (field.dist,))
    if with_profile:
        profile_window("radio 1024^2", lambda: kl_text(opt.update(samples, state)),
                       sums=K7_PROFILE_SUMS)
        print("radio 1024^2 profile as first written (NVIDIA H100 80GB HBM3, 700.00 W): the K7 "
              "spread 3337 ms over 4032 calls, device busy 6.447 s of 13.656", flush=True)
    return counts, k7, (lh, rr, std, ref)


# phase 35's profile: the K7 kernels' device time, by the kernels' names
K7_PROFILE_SUMS = {"K7 spread (the values' gather and the sums)": ("nufft_spread",
                                                                    "nufft_gather"),
                   "K7 interpolation": ("nufft_interp",), "K7 factor tables": ("nufft_factors",)}


@phase("36 the new minimizers on the card: the 128^2 posterior's KL, 10 iterations each, and "
       "one lockstep update with trust-region Newton-CG")
def phase_solvers(jt, lh, samples):
    """Phase 5's posterior (the 128^2 headline config and its 8 samples):
    its KL minimized from the same start (the samples' expansion point) by
    each of `trust_ncg` (its subproblem at most 30 CG-Steihaug steps),
    `lbfgs`, `vlbfgs`, `nonlinear_cg`, `steepest_descent` and
    `minimize_scipy(method="L-BFGS-B")`, 10 iterations each; then one
    `OptimizeVI.update` (`BENCH_KWARGS`, `residual_map="vmap"`) whose
    nonlinear sample update is trust-region Newton-CG (5 iterations of at
    most 20 CG-Steihaug steps), run by its lockstep form.  Prints each run's
    seconds, energy, `nit`, `status` and gradient evaluations.  The checks:
    each minimizer lowers the KL energy and stays finite; the update's
    latents are finite, each sample's trust-region status is not negative,
    and its KL stage lowers the energy from where it starts.  Returns the
    distributor's counts of the update."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.solvers import minimize_scipy
    from nifty_tpu_torch.solvers.descent import _nonlinear_cg, _steepest_descent
    from nifty_tpu_torch.solvers.lbfgs import _lbfgs
    from nifty_tpu_torch.solvers.newton_cg import _newton_cg
    from nifty_tpu_torch.solvers.trust_ncg import _trust_ncg
    from nifty_tpu_torch.solvers.vlbfgs import _vlbfgs

    opt = jt.OptimizeVI(lh, n_total_iterations=100, residual_map="vmap")
    e0 = float(opt.kl_value_and_grad(lh, samples.pos, primals_samples=samples)[0])
    print(f"128^2 posterior: KL energy {e0!r} at the start", flush=True)
    runs = (("trust_ncg", _trust_ncg, dict(maxiter=10, subproblem_kwargs=dict(maxiter=30))),
            ("lbfgs", _lbfgs, dict(maxiter=10)), ("vlbfgs", _vlbfgs, dict(maxiter=10)),
            ("nonlinear_cg", _nonlinear_cg, dict(maxiter=10)),
            ("steepest_descent", _steepest_descent, dict(maxiter=10)),
            ("minimize_scipy L-BFGS-B", minimize_scipy, dict(method="L-BFGS-B", maxiter=10)))
    for name, minimize, kw in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = opt.kl_minimize(samples, minimize=minimize, minimize_kwargs=kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        energy = float(res.fun)
        print(f"128^2 KL by {name}: {secs:.3f} s | energy {energy!r} ({energy - e0:+.6e}) | nit "
              f"{int(res.nit)} | status {int(res.status)} | gradient evaluations "
              f"{int(res.njev)}" + (f" | Hessian products {int(res.nhev)}"
                                    if res.nhev is not None else ""), flush=True)
        finite = np.isfinite(energy) and all(bool(torch.isfinite(x).all())
                                             for x in res.x.values())
        if not (finite and energy < e0):
            raise AssertionError(f"128^2 KL by {name}: energy {energy} not finite and below "
                                 f"the start's {e0}")
    starts = []

    def newton_cg_from_start(fun=None, x0=None, **kw):
        starts.append(float(kw["fun_and_grad"](x0)[0]))
        return _newton_cg(fun, x0, **kw)

    kwargs = dict(BENCH_KWARGS, nonlinearly_update_kwargs=dict(
        minimize=_trust_ncg, minimize_kwargs=dict(maxiter=5, subproblem_kwargs=dict(maxiter=20))),
                  kl_kwargs=dict(BENCH_KWARGS["kl_kwargs"], minimize=newton_cg_from_start))
    state = opt.init_state(jt.HostKey(36), **kwargs)
    bg.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, state = opt.update(jt.Samples(pos=samples.pos, samples=None, keys=None), state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts(bg)
    st = state.sample_state
    energy = float(state.minimization_state.fun)
    print(f"128^2 update, the nonlinear sample update by trust_ncg in lockstep: {secs:.3f} s | "
          f"per sample nit {st.nit.tolist()}, status {st.status.tolist()}, gradient evaluations "
          f"{st.njev.tolist()}, Hessian products {st.nhev.tolist()} | KL energy {energy!r} from "
          f"{starts[0]!r} | distributor calls by rows: {rows_text(counts)}", flush=True)
    finite = all(bool(torch.isfinite(leaf).all()) for s in new for leaf in s.values())
    if not (finite and bool((st.status >= 0).all()) and energy < starts[0]):
        raise AssertionError(f"128^2 lockstep trust_ncg update: finite {finite}, statuses "
                             f"{st.status.tolist()}, KL energy {energy} from {starts[0]}")
    require_launches("128^2 lockstep trust_ncg update", counts)
    return counts


def k7_kernel_entries(kres, factor_res, runs, checked, dtype="float64"):
    """The `kernels` line's entries of K7: one for each direction, table and
    number of rows that the runs ({run: K7 counts}) launched, with phase
    34's numbers, and one for each factor table they built; fails on a
    shape that phase 34 did not check, among these runs' and the `checked`
    runs' (phase 4's card runs).  `dtype`: the float type of the runs'
    calls and of phase 34's numbers."""
    entries = []
    for kind, name, replaces in (("interp", "window_interp", ":204-247"),
                                 ("spread", "window_spread", ":251-265")):
        by_run = {run: c[kind] for run, c in runs.items()}
        for shape in set().union(*(c[kind] for c in checked.values())):
            if shape not in kres:
                raise AssertionError(f"{name} launched at {shape}, a shape that phase 34 did not "
                                     f"hold against the plain version")
        for shape in sorted(set().union(*by_run.values())):
            key = shape if dtype == "float64" else shape + (dtype,)
            if key not in kres:
                raise AssertionError(f"the main path launched {name} at {key}, a shape that "
                                     f"phase 34 did not hold against the plain version and time")
            r = kres[key]
            (os_shape, npts, width), nrows = shape
            launches = next(c[shape] for c in by_run.values() if c.get(shape))
            entries.append(dict(
                name=f"{name} (K7, {'x'.join(map(str, os_shape))} grid x {npts} points, W "
                     f"{width}, B={nrows}, {dtype})",
                route="cuda", source="nifty_tpu_torch/csrc/nufft_window.cu",
                replaces=f"nifty_tpu/ops/nufft.py{replaces} (XLA in the JAX package, not Pallas)",
                # the spread launches two kernels a call: the values' gather, the sums
                launches=launches, kernel_launches=launches * (2 if kind == "spread" else 1),
                launches_by_run={run: c.get(shape, 0) for run, c in by_run.items()},
                max_abs_err=r[f"{kind}_err"], ms=r[f"{kind}_device_ms"],
                plain_ms=r[f"{kind}_plain_ms"], bound_ms=r[f"{kind}_bound_ms"],
                bound_by=r[f"{kind}_bound_by"], library_ms=r[f"{kind}_library_ms"],
            ))
    by_run = {run: c["factors"] for run, c in runs.items()}
    for key in sorted(set().union(*by_run.values())):
        fkey = key if dtype == "float64" else (key, dtype)
        if fkey not in factor_res:
            raise AssertionError(f"the main path built a K7 factor table at {fkey}, a shape that "
                                 f"phase 34 did not hold against the plain version and time")
        f = factor_res[fkey]
        os_shape, npts, width = key
        launches = next(c[key] for c in by_run.values() if c.get(key))
        entries.append(dict(
            name=f"window factors (K7's factor table, {'x'.join(map(str, os_shape))} grid x "
                 f"{npts} points, W {width}, {dtype})",
            route="cuda", source="nifty_tpu_torch/csrc/nufft_window.cu",
            replaces="nifty_tpu/ops/nufft.py:204-247 (the weights of interp_point; XLA in the "
                     "JAX package, not Pallas)",
            launches=launches, kernel_launches=launches,
            launches_by_run={run: c.get(key, 0) for run, c in by_run.items()},
            max_abs_err=f["err"], ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
            bound_by=f["bound_by"], library_ms=None,
        ))
    return entries


# -- the config file and instrumentation (phases 41-42) ---------------------------

# `demos/7_config_file.py`'s INI text and seed
DEMO7_CONFIG = """
[optimize_kl]
n_total_iterations = 4
n_samples = 1*1,3*2
draw_linear_kwargs = *cg_conservative
odir = none

[cg_base]
maxiter = 40

[cg_conservative]
base = cg_base
absdelta = 1e-5
"""
DEMO7_SEED = 11


def ini_sections(text):
    import configparser

    cp = configparser.ConfigParser()
    cp.optionxform = str
    cp.read_string(text)
    return {name: dict(cp[name]) for name in cp.sections()}


def demo7_field(jt):
    """`demos/7_config_file.py`'s 64^2 field."""
    dims = (64, 64)
    return jt.SimpleCorrelatedField(
        dims, 1.0 / dims[0], offset_mean=0.0, offset_std=(1e-1, 1e-2),
        fluctuations=(1.0, 0.5), loglogavgslope=(-3.0, 0.5), flexibility=None)


def phase9_twin_config(jt, lh, k_opt, odir):
    """Phase 9's `optimize_kl` arguments as an INI file: its schedules as
    run-length lists or `*section` builders (the schedule syntax is
    numeric, so the string schedule `sample_mode` is built), its floats as
    their `repr`, its key as the int seed `seed`."""
    delta = 1e-4
    size = jt.tree.size(lh.domain)
    return f"""
[optimize_kl]
n_total_iterations = 3
n_samples = 2*2,4
sample_mode = *sample_mode
draw_linear_kwargs = *draw_linear
nonlinearly_update_kwargs = *nonlinearly_update
kl_kwargs = *kl
seed = {k_opt!r}
odir = {odir}

[sample_mode]
nonlinear_from = 2

[draw_linear]
absdelta = {delta * size / 10.0!r}
maxiter = 100

[nonlinearly_update]
xtol = {delta!r}
maxiter = 5

[kl]
absdelta = {delta * size!r}
maxiter = 25
"""


PHASE9_TWIN_BUILDERS = {
    "sample_mode": lambda nonlinear_from: (
        lambda i: "nonlinear_resample" if i >= nonlinear_from else "linear_resample"),
    "draw_linear": lambda **kw: dict(cg_kwargs=kw),
    "nonlinearly_update": lambda **kw: dict(minimize_kwargs=kw),
    "kl": lambda **kw: dict(minimize_kwargs=kw),
}


@phase("41 the config file: demos/7_config_file.py at 64^2, and phase 9's run from an INI file")
def phase_config_file(jt, phase9_energy):
    """`demos/7_config_file.py` through the port (its INI text, 64^2, seed
    11; section inheritance, a run-length `n_samples`, a `*section`
    builder): its check, relative error below 0.5.  Then phase 9's model,
    keys and budgets as an INI file read by `OptimizeKLConfig.from_file`,
    its KL energy after 3 iterations bitwise phase 9's, with
    `export_operator_outputs` (where h5py imports) and
    `save_samples_to_fits` of the signal: the FITS mean read back equal to
    the host mean of the card's samples (and to the HDF5 export's).  Fails
    unless K3 and K4 launched in each run.  Returns both runs' counts."""
    from nifty_tpu_torch.ops import bin_gather as bg

    cfg = jt.OptimizeKLConfig(ini_sections(DEMO7_CONFIG),
                              builders={"cg_conservative": lambda **kw: dict(cg_kwargs=kw)})
    cf = demo7_field(jt)
    key, k1, k2, k3 = jt.split(DEMO7_SEED, 4)
    with torch.no_grad():
        truth = cf(cf.init(k1))
        data = truth + 0.1 * jt.random_like(k2, truth)
    lh = jt.Gaussian(data, noise_std_inv=lambda x: x / 0.1).amend(cf)
    bg.reset_launch_counts()
    t0 = time.perf_counter()
    samples, state = cfg.optimize_kl(lh, jt.Vector(lh.init(k3)), key=key)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c_demo7 = launch_counts(bg)
    with torch.no_grad():
        resid = torch.stack([cf(s) for s in samples]).mean(0) - truth
    err = float(torch.sqrt(torch.mean(resid ** 2) / torch.mean(truth ** 2)))
    print(f"demo 7: {int(state.nit)} iterations, {len(samples)} samples in {seconds:.3f} s | KL "
          f"energy {float(state.minimization_state.fun)!r} | relative reconstruction error "
          f"{err:.4f} (the demo's check: < 0.5) | launches gather {c_demo7['gather']} segment_sum "
          f"{c_demo7['segsum']}, by map: {maps_text(c_demo7)}", flush=True)
    if not err < 0.5:
        raise AssertionError(f"demo 7: relative reconstruction error {err} is not below 0.5")
    require_launches("demo 7", c_demo7, (cf.dist,))

    signal, lh, _, _, k_init, k_opt, _ = demo0_problem(jt)
    with tempfile.TemporaryDirectory() as odir:
        ini = os.path.join(odir, "phase9.ini")
        with open(ini, "w") as f:
            f.write(phase9_twin_config(jt, lh, k_opt, odir))
        cfg = jt.OptimizeKLConfig.from_file(ini, builders=PHASE9_TWIN_BUILDERS)
        export = {"signal": signal} if present("h5py") else None
        if export is None:
            print("phase 9's twin: no export_operator_outputs (h5py: absent)", flush=True)
        bg.reset_launch_counts()
        t0 = time.perf_counter()
        samples, state = cfg.optimize_kl(lh, jt.random_like(k_init, lh.domain),
                                         export_operator_outputs=export)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        c_twin = launch_counts(bg)
        with torch.no_grad():
            host_mean = np.stack([signal(s).cpu().numpy() for s in samples]).mean(0)
        base = os.path.join(odir, "signal")
        jt.save_samples_to_fits(samples, base, signal)
        fits_mean = jt.read_fits(base + ".mean.fits")
        h5_same = None
        if export is not None:
            import h5py

            with h5py.File(os.path.join(odir, "operator_outputs.h5")) as f:
                h5_same = bool(np.array_equal(f["signal/mean"][...], fits_mean))
                h5_shape = f["signal/samples"].shape
        files = sorted(os.listdir(odir))
    energy = float(state.minimization_state.fun)
    print(f"phase 9's twin from an INI file: {int(state.nit)} iterations in {seconds:.3f} s | KL "
          f"energy after 3 {energy!r}, phase 9's {phase9_energy!r}: bitwise equal "
          f"{energy == phase9_energy} | odir {files} | FITS mean {fits_mean.shape} equal to the "
          f"host mean of the card's samples: {bool(np.array_equal(fits_mean, host_mean))}"
          + ("" if h5_same is None else f", to operator_outputs.h5's mean: {h5_same} (samples "
             f"{h5_shape})")
          + f" | launches gather {c_twin['gather']} segment_sum {c_twin['segsum']}, by rows of "
          f"the table: {rows_text(c_twin)}", flush=True)
    if energy != phase9_energy:
        raise AssertionError(f"the config-file run ends at {energy!r}, phase 9 at "
                             f"{phase9_energy!r}")
    if not np.array_equal(fits_mean, host_mean) or h5_same is False:
        raise AssertionError("the exported mean differs from the samples' host mean")
    require_launches("phase 9's twin", c_twin)
    return c_demo7, c_twin


@phase("42 instrumentation at 4096^2: exec_time of phase 6's likelihood, CountingModel of its "
       "field")
def phase_instrumentation(jt, lh, samples, field, smi_line):
    """`exec_time` of phase 6's 4096^2 `n_bins=128` likelihood at its
    posterior position (forward, jvp, value_and_grad and metric; one warm-up
    call, then 3 timed, the card synchronized after each), then
    `CountingModel` around its correlated field through a forward, a jvp
    and a vjp, with its report.  Fails unless K1 and K2 launched on the
    2049^2 quarter map.  Returns the launch counts."""
    from nifty_tpu_torch.ops import bin_gather as bg

    pos = samples.pos
    bg.reset_launch_counts()
    times = jt.exec_time(lh, pos, key=jt.HostKey(42), n=3, verbose=False)
    cm = jt.CountingModel(field, name="4096^2 n_bins=128 correlated field")
    tangent = jt.random_like(jt.HostKey(43), pos)
    with torch.no_grad():
        out = cm(pos)
    cm.jvp(pos, tangent)
    cm.vjp(pos, jt.random_like(jt.HostKey(44), out))
    torch.cuda.synchronize()
    counts = launch_counts(bg)
    print("exec_time 4096^2 n_bins=128 likelihood (" + str(jt.tree.size(pos)) + " dof): "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in times.items())
          + f" | {smi_line} | {cm.report()} | launches gather {counts['gather']} segment_sum "
          f"{counts['segsum']}, by map: {maps_text(counts)}", flush=True)
    if list(times) != ["forward", "jvp", "value_and_grad", "metric"]:
        raise AssertionError(f"exec_time returned {list(times)}")
    if not all(np.isfinite(v) and v > 0 for v in times.values()):
        raise AssertionError(f"exec_time: {times}")
    if cm.counts != {"forward": 1, "jvp": 1, "vjp": 1}:
        raise AssertionError(f"CountingModel counted {cm.counts}")
    require_launches("instrumentation 4096^2", counts, (field.dist,))
    return counts


# -- mesh parallelism (phases 37-40) ----------------------------------------------
#
# The worlds are processes of their own (`nifty_tpu_torch.parallel.run_world`,
# spawned): each rank imports this file, so what they run is a function at
# its top level.  A world runs every case it serves in one go.

#: `demos/4_multichip.py` through the JAX package on 4 virtual CPU devices
#: (`XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu
#: python demos/4_multichip.py`): its posterior-mode RMS error.  Phase 38
#: draws its own truth and noise (the port's generator), so it is held to
#: this figure times the margin, not to it.
DEMO4_JAX_RMS = 0.0723
DEMO4_RMS_MARGIN = 1.5
#: phase 6's field at 4096^2 and the (64 x 32) field of phases 38 and 40
MESH_4096 = (4096, 4096)
MESH_DEMO4 = (64, 32)
#: phase 37's transforms: the 4096^2 field, a 3-D pencil, the 1-D four-step
#: and a partner axis that the field ranks do not divide
MESH_TRANSFORMS = {"4096^2": MESH_4096, "256^3 pencil": (256,) * 3,
                   "1-D 2^24 four-step": (2 ** 24,),
                   "4096 x 4095 (partner axis not divisible)": (4096, 4095)}
#: `optimize_kl` budgets of phase 40 (deterministic fixed trips: short),
#: with the maps left at "auto" as a user's run leaves them: on the card
#: under `deterministic_reductions` with a mesh active "auto" is the sample
#: loop (the lockstep maps' row sums would part the worlds; they raise on
#: a samples axis of several ranks, which phase 40 checks).
CKPT_KWARGS = dict(
    n_samples=4,
    draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=5)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=5))),
    kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=2, cg_kwargs=dict(maxiter=5))),
    sample_mode="nonlinear_resample",
)


#: phase 45's budgets: `BENCH_KWARGS`' 4 pairs (a key for each rank of 4 x
#: 1) at shorter fixed trips (draw CG 20, geoVI 2 x CG 10, KL 3 x CG 15).
#: Under `deterministic_reductions` every solver runs all its trips, and
#: the 1 x 1 world runs the 8 samples in turn: at `BENCH_KWARGS` the two
#: worlds took more of the script's time limit than the other phases leave
MESH_ICR_KWARGS = dict(
    BENCH_KWARGS, draw_linear_kwargs=dict(cg_kwargs=dict(maxiter=20)),
    nonlinearly_update_kwargs=dict(minimize_kwargs=dict(
        xtol=1e-3, maxiter=2, cg_kwargs=dict(maxiter=10))),
    kl_kwargs=dict(minimize_kwargs=dict(xtol=1e-4, maxiter=3, cg_kwargs=dict(maxiter=15))))


def digest_tree(tree):
    """:func:`digest` of a tree's leaves, raveled and joined in flatten
    order."""
    from nifty_tpu_torch.tree import tree_leaves

    return digest(torch.cat([x.detach().reshape(-1) for x in tree_leaves(tree)]))


def mesh_rank(cases):
    """What a rank of a phase-37-40 world runs: ``cases`` ``(name, function
    name, kwargs)``; each function takes the package first and returns
    picklable results; its seconds are added."""
    import nifty_tpu_torch as jt
    from nifty_tpu_torch.parallel.mesh import active_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jt.logger.setLevel(logging.WARNING)
    out = {}
    for name, fn, kwargs in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = globals()[fn](jt, **kwargs)
        torch.cuda.synchronize()
        out[name] = dict(res, seconds=time.perf_counter() - t0)
        mesh = active_mesh()
        if mesh is not None:
            mesh.deactivate()
        jt.config.update("deterministic_reductions", False)
    return out


def _rel_err(got, want):
    """max |got - want| over max |want|, over the field group's ranks."""
    return float((got - want).abs().max() / want.abs().max())


def mesh_transforms(jt, samples, field):
    """Phase 37's transforms: each rank's rows of ``distributed_hartley`` and
    ``distributed_fftn``, forward and adjoint (autograd), against the
    whole-field transform on one rank (``ops.harmonic.hartley``,
    ``torch.fft``); device ms of the 4096^2 pencil Hartley transform."""
    from nifty_tpu_torch.ops.distributed_fft import distributed_fftn, distributed_hartley
    from nifty_tpu_torch.ops.harmonic import hartley
    from nifty_tpu_torch.parallel import collectives as coll
    from nifty_tpu_torch.parallel import make_mesh

    mesh = make_mesh(samples, field)
    fg = mesh.group(mesh.field_axis)
    dev = jt.config.default_device()
    gen = torch.Generator(device=dev).manual_seed(37)
    res = {}
    for label, shape in MESH_TRANSFORMS.items():
        x, y, w = (torch.randn(shape, dtype=torch.float64, device=dev, generator=gen)
                   for _ in range(3))
        z = torch.complex(x, w)
        xs, ys, zs, ws = (mesh.own_rows(v) for v in (x, y, z, torch.complex(y, w)))
        errs = {}
        errs["hartley"] = _rel_err(distributed_hartley(xs, mesh), mesh.own_rows(hartley(x)))
        xg = xs.clone().requires_grad_(True)
        (distributed_hartley(xg, mesh) * ys).sum().backward()
        errs["hartley adjoint"] = _rel_err(xg.grad, mesh.own_rows(hartley(y)))
        errs["fftn"] = _rel_err(distributed_fftn(zs, mesh), mesh.own_rows(torch.fft.fftn(z)))
        zg, zl = zs.clone().requires_grad_(True), z.clone().requires_grad_(True)
        (distributed_fftn(zg, mesh).conj() * ws).real.sum().backward()
        (torch.fft.fftn(zl).conj() * torch.complex(y, w)).real.sum().backward()
        errs["fftn adjoint"] = _rel_err(zg.grad, mesh.own_rows(zl.grad))
        worst = coll.all_reduce(torch.tensor(list(errs.values()), device=dev), fg,
                                op=coll.dist.ReduceOp.MAX) if fg is not None else \
            torch.tensor(list(errs.values()))
        res[label] = dict(zip(errs, worst.tolist()))
        if shape == MESH_4096:
            for _ in range(3):
                distributed_hartley(xs, mesh)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                distributed_hartley(xs, mesh)
            stop.record()
            torch.cuda.synchronize()
            res["hartley 4096^2 ms"] = start.elapsed_time(stop) / 10
            res["hartley 4096^2 local ms"] = cuda_ms(lambda: hartley(x), n=10)
        del x, y, w, z, xs, ys, zs, ws, xg, zg, zl
    return res


def mesh_kernels(jt, samples, field):
    """Phase 37's kernel checks: this rank's slab of the 4096^2 ``n_bins=128``
    map and its (row, bin) map, the gather and both segment sums against
    their plain versions, as the field-sharded distributor runs them."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.parallel import make_mesh

    mesh = make_mesh(samples, field)
    grid = jt.make_grid(MESH_4096, 1.0 / MESH_4096[0], "fourier", n_bins=128)
    full = np.asarray(grid.harmonic_grid.power_distributor)
    nb = int(np.asarray(grid.harmonic_grid.mode_lengths).size)
    rows = mesh.own_rows(torch.from_numpy(full)).numpy()
    dev = jt.config.default_device()
    slab = bg.BinIndex(rows, nb=nb).to(dev)
    rowbin = bg.row_bin_index(rows, nb).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(mesh.index(mesh.field_axis)))
    table = torch.randn((1, nb), dtype=torch.float64, device=dev, generator=gen)
    cot = torch.randn((1, slab.n), dtype=torch.float64, device=dev, generator=gen)
    out = dict(gather=bool(torch.equal(bg.bin_gather(table, slab),
                                       bg.bin_gather_plain(table, slab.idx))))
    for name, dist in (("segment sum", slab), ("rows x bins segment sum", rowbin)):
        got = bg.bin_segment_sum(cot, dist)
        plain = bg.bin_segment_sum_plain(cot, dist.perm, dist.offsets)
        scale = bg.bin_segment_sum_plain(cot.abs(), dist.perm, dist.offsets).clamp_min(1e-300)
        out[name] = float(((got - plain).abs() / scale).max())
    out["map"] = (slab.shape, nb, rowbin.nb)
    out.update(mesh_los_slab(jt, mesh))
    return out


def mesh_los_slab(jt, mesh):
    """Phase 37's check of K11's slab route: phase 44's 256^3 rays on this
    rank's rows of a field drawn whole from a seed; the ray values by
    `integrate_slab` (the kernels, the (ray, row) partials gathered over
    the field group and folded) against the whole grid's plain forward,
    and the slab adjoint (the kernel) against the plain adjoint's rows,
    within 1e-12 of the per-output sum of |term|."""
    from nifty_tpu_torch.ops import los_interp as li

    dev = jt.config.default_device()
    los = tomography_rays(jt, **TOMO256_RAYS)
    p, i = mesh.size(mesh.field_axis), mesh.index(mesh.field_axis)
    n0 = TOMO256_RAYS["dims"][0]
    slab = los.slab_tables((i * n0 // p, (i + 1) * n0 // p), torch.float64)
    whole = los.table(torch.float64)
    gen = torch.Generator(device=dev).manual_seed(44)
    f = torch.randn((1,) + TOMO256_RAYS["dims"], dtype=torch.float64, device=dev, generator=gen)
    ybar = torch.randn((1, whole.nrays), dtype=torch.float64, device=dev, generator=gen)
    local = mesh.own_rows(f, dim=1)
    got = li.integrate_slab(local, slab, mesh.group(mesh.field_axis), True)
    flat = f.reshape(1, -1)
    fwd_rel = float(((got - li.los_integrate_plain(flat, whole)).abs()
                     / li.sum_abs_terms(whole, f=flat).clamp_min(1e-300)).max())
    adj = li.los_integrate_adjoint(ybar, slab.table).reshape(local.shape)
    want = mesh.own_rows(li.los_integrate_adjoint_plain(ybar, whole).reshape(f.shape), dim=1)
    scale = mesh.own_rows(li.sum_abs_terms(whole, ybar=ybar).reshape(f.shape), dim=1)
    adj_rel = float(((adj - want).abs() / scale.clamp_min(1e-300)).max())
    return {"K11 slab forward": fwd_rel, "K11 slab adjoint": adj_rel,
            "K11 slab rows": slab.rows}


def mesh_pairwise(jt, samples):
    """Phase 37: ``pairwise_mean`` of 8 rows spread over ``samples`` ranks,
    its digest, and how it ran."""
    from nifty_tpu_torch.parallel import make_mesh, pairwise_mean

    mesh = make_mesh(samples, _world_ranks() // samples)
    dev = jt.config.default_device()
    x = torch.randn((8, 1000), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    got = pairwise_mean(mesh.own_rows(x, mesh.sample_axis), mesh=mesh)
    return dict(digest=digest_tree(got), one=digest_tree(pairwise_mean(x)),
                stats=dict(mesh.stats))


def _world_ranks():
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def demo4_field(jt, mesh):
    """`demos/4_multichip.py`'s field on the mesh's field ranks (its grid
    (32 n_f, 32) at n_f = 2; its priors) with the pencil Hartley."""
    from nifty_tpu_torch.ops.distributed_fft import distributed_hartley

    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(MESH_DEMO4, 1.0 / MESH_DEMO4[0], (1.0, 0.5), (-3.0, 0.2))
    hfn = None if mesh is None else (lambda x, axes=None: distributed_hartley(x, mesh, axes=axes))
    return cfm.finalize(hartley_fn=hfn)


def demo4_likelihood(jt, mesh, noise=0.1):
    """The demo's truth (a prior draw) and data (white noise of 0.1), drawn
    whole on every rank, then the likelihood placed on the mesh."""
    from nifty_tpu_torch.parallel import shard_position

    whole = demo4_field(jt, None)
    key, k1, k2 = jt.split(0, 3)
    with torch.no_grad():
        truth = whole(whole.init(k1))
        data = truth + noise * jt.random_like(k2, truth)
    lh = jt.Gaussian(data, noise_cov_inv=lambda x: x / noise ** 2).amend(demo4_field(jt, mesh))
    return shard_position(lh, mesh), truth, key


def mesh_demo4(jt, samples, field, n_iterations=4):
    """Phase 38: `demos/4_multichip.py`'s loop through the port: each
    iteration an antithetic linear draw (CG 40) of two keys, the keys'
    rows spread over the samples ranks, then Newton-CG on the KL (10
    steps, CG 20, xtol 1e-4); the KL energies and the posterior mode's RMS
    error against the truth."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.parallel import collectives as coll
    from nifty_tpu_torch.parallel import make_mesh, shard_position
    from nifty_tpu_torch.parallel.mesh import sample_rows

    mesh = make_mesh(samples, field)
    lh, truth, key = demo4_likelihood(jt, mesh)
    pos = shard_position(jt.random_like(key, lh.domain), mesh)
    opt = jt.OptimizeVI(lh, n_total_iterations=n_iterations)
    bg.reset_launch_counts()
    energies = []
    for _ in range(n_iterations):
        key, sk = jt.split(key, 2)
        keys = jt.split(sk, max(samples, 2))
        first, count = sample_rows(mesh, len(keys))
        smp, _ = opt.draw_linear_samples(pos, keys[first:first + count],
                                         cg_kwargs=dict(maxiter=40))
        res = opt.kl_minimize(smp, minimize_kwargs=dict(maxiter=10, xtol=1e-4,
                                                        cg_kwargs=dict(maxiter=20)))
        pos = res.x
        energies.append(float(res.fun))
    with torch.no_grad():
        mode = lh.model(pos)
        sq = coll.all_reduce(((mode - mesh.own_rows(truth)) ** 2).sum().reshape(1),
                             mesh.group(mesh.field_axis))
    rms = float(torch.sqrt(sq / truth.numel()))
    return dict(energies=energies, rms=rms, counts=launch_counts(bg))


def mesh_checkpoint_write(jt, samples, field, odir):
    """Phase 40: ``optimize_kl(checkpoint_format="orbax")`` for 2
    iterations (`deterministic_reductions`), then a third continued in
    memory; digests of the whole samples after each."""
    import torch.distributed as dist

    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.parallel import gather_samples, make_mesh, shard_position

    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    lh, _, key = demo4_likelihood(jt, mesh)
    pos = shard_position(jt.random_like(key, lh.domain), mesh)
    # the lockstep maps refuse this world; "auto" loops over samples
    opt = jt.OptimizeVI(lh, n_total_iterations=2)
    try:
        jt.OptimizeVI(lh, n_total_iterations=2, residual_map="vmap").draw_linear_samples(
            pos, jt.split(0, 2))
        refused = False
    except ValueError:
        refused = True
    bg.reset_launch_counts()
    kw = dict(key=jt.HostKey(40), checkpoint_format="orbax", **CKPT_KWARGS)
    s2, st2 = jt.optimize_kl(lh, pos, n_total_iterations=2, odir=odir, **kw)
    # this rank's share of the checkpoint is on disk: the NCCL world, which
    # runs beside this one, resumes from it once every rank has said so
    with open(os.path.join(odir, f"written_{dist.get_rank()}"), "w"):
        pass
    s3, st3 = jt.optimize_kl(lh, s2, n_total_iterations=3, odir=os.path.join(odir, "in_memory"),
                             _optimize_vi_state=st2, **kw)
    whole = gather_samples(s3, mesh)
    return dict(energy=float(st3.minimization_state.fun), nit=int(st3.nit),
                digest=digest_tree((whole.pos, whole._samples)), counts=launch_counts(bg),
                files=sorted(os.listdir(os.path.join(odir, "last_ckpt"))),
                auto_maps=(opt.lockstep, opt.kl_map), vmap_refused=refused)


def wait_for_checkpoint(src, nranks, timeout=600.0):
    """Seconds spent waiting until each of the `nranks` ranks of the world
    that writes phase 40's checkpoint ``src`` has marked its share written
    (`mesh_checkpoint_write`)."""
    t0 = time.monotonic()
    marks = [os.path.join(os.path.dirname(src), f"written_{r}") for r in range(nranks)]
    while not all(os.path.exists(m) for m in marks):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"phase 40's checkpoint {src} was not written in {timeout:.0f} s")
        time.sleep(0.5)
    return time.monotonic() - t0


def mesh_checkpoint_resume(jt, samples, field, src, odir, writers=0):
    """Phase 40: the third iteration resumed from ``src`` (the checkpoint
    phase 40 wrote on 2 x 2) on this world, once its `writers` ranks have
    marked it written (0: it is, this world wrote it)."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.parallel import gather_samples, make_mesh

    waited = wait_for_checkpoint(src, writers) if writers else 0.0
    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    lh, _, _ = demo4_likelihood(jt, mesh)
    bg.reset_launch_counts()
    s3, st3 = jt.optimize_kl(lh, None, n_total_iterations=3, odir=odir, resume=src,
                             key=jt.HostKey(40), checkpoint_format="orbax", **CKPT_KWARGS)
    whole = gather_samples(s3, mesh)
    return dict(energy=float(st3.minimization_state.fun), nit=int(st3.nit),
                digest=digest_tree((whole.pos, whole._samples)), counts=launch_counts(bg),
                waited=waited)


def mesh_update_4096(jt, samples, field, data_file, out_dir, tag):
    """Phase 39: phase 6's 4096^2 ``n_bins=128`` model (its data, read from
    ``data_file``), field- and sample-sharded, under
    ``deterministic_reductions``: the stages and one update with ``BENCH_KWARGS`` and the sample
    loop; s/update, peak memory, collectives and kernel launches of the
    update; the whole samples saved as ``out_dir/<tag>_*.npy`` by rank 0.
    The stages: the energy, a metric matvec and a 20-step CG draw."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops.distributed_fft import distributed_hartley
    from nifty_tpu_torch.parallel import collectives as coll
    from nifty_tpu_torch.parallel import gather_samples, make_mesh, shard_position
    from nifty_tpu_torch.parallel.mesh import gather_position

    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    dev = jt.config.default_device()
    cfm = jt.CorrelatedFieldMaker("cf")
    cfm.set_amplitude_total_offset(offset_mean=1.0, offset_std=(1e-1, 3e-2))
    cfm.add_fluctuations(MESH_4096, distances=1.0 / MESH_4096[0], fluctuations=(1.0, 5e-1),
                         loglogavgslope=(-3.0, 2e-1), flexibility=(1e0, 5e-1),
                         asperity=(5e-1, 5e-2), n_bins=128)
    cf = cfm.finalize(hartley_fn=lambda x, axes=None: distributed_hartley(x, mesh, axes=axes))
    data = torch.from_numpy(np.load(data_file)).to(dev)
    lh = shard_position(jt.Gaussian(data, noise_cov_inv=lambda x: x / NOISE_STD ** 2).amend(cf),
                        mesh)
    del data
    pos = shard_position(jt.random_like(1, lh.domain), mesh)
    tan = shard_position(jt.random_like(5, lh.domain), mesh)
    # the noise of a slab tree: each sharded leaf drawn whole and cut to the
    # rank's rows, beside a draw of the slab's shape alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jt.random_like(11, tan)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.randn(tan["cfxi"].shape, dtype=torch.float64, device=dev,
                generator=torch.Generator(device=dev).manual_seed(11))
    torch.cuda.synchronize()
    draw_s = dict(slab_tree=t1 - t0, slab_leaf_alone=time.perf_counter() - t1)
    energy = float(lh(pos))
    metric = gather_position(lh.metric(pos, tan), mesh)
    draw, _ = jt.draw_linear_residual(lh, pos, 3, cg_kwargs=dict(maxiter=20))
    draw = gather_position(draw, mesh)
    stages = dict(energy=energy, metric=digest_tree(metric), draw=digest_tree(draw))
    del metric, draw, tan
    opt = jt.OptimizeVI(lh, n_total_iterations=100, residual_map="smap", kl_map="smap")
    state = opt.init_state(7, **BENCH_KWARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bg.reset_launch_counts()
    coll.reset_counts()
    mesh.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smp, state = opt.update(jt.Samples(pos=pos), state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, colls, nbytes = launch_counts(bg), dict(coll.COUNTS), dict(coll.BYTES)
    stats = dict(mesh.stats)
    whole = gather_samples(smp, mesh)
    if mesh.is_root:
        for name, tree in (("pos", whole.pos), ("samples", whole._samples)):
            for k, v in tree.items():
                np.save(os.path.join(out_dir, f"{tag}_{name}_{k}.npy"), v.cpu().numpy())
    return dict(stages=stages, seconds_update=secs, energy=float(state.minimization_state.fun),
                newton=int(state.minimization_state.nit), peak_gib=peak, counts=counts,
                collectives=colls, collective_bytes=nbytes, stats=stats,
                digest=digest_tree((whole.pos, whole._samples)), noise_draw_s=draw_s)


def mesh_tomography_256(jt, samples, field, data_file, noise_std, out_dir, tag):
    """Phase 44: phase 27's 256^3 model (its data, read from `data_file`,
    and its noise) at full width, field- and sample-sharded, under
    `deterministic_reductions`: one update from phase 27's state and start
    (`TOMO256_KWARGS`, the sample loop); s/update, peak memory, the
    collectives of the update by kind and bytes, K11's launches by (table,
    rows) and the distributor's by map, whether this rank's latents are
    finite, the whole samples' digest (saved as `out_dir/<tag>_*.npy` by
    rank 0)."""
    from nifty_tpu_torch.ops import bin_gather as bg
    from nifty_tpu_torch.ops import los_interp as li
    from nifty_tpu_torch.ops.distributed_fft import distributed_hartley
    from nifty_tpu_torch.parallel import collectives as coll
    from nifty_tpu_torch.parallel import gather_samples, make_mesh, shard_position
    from nifty_tpu_torch.tree import tree_leaves

    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, field)
    dev = jt.config.default_device()
    fwd, cf, los = tomography_model(
        jt, **TOMO256_RAYS, n_bins=128,
        hartley_fn=lambda x, axes=None: distributed_hartley(x, mesh, axes=axes))
    data = torch.from_numpy(np.load(data_file)).to(dev)
    lh = shard_position(jt.Gaussian(data, noise_cov_inv=lambda x: x / noise_std ** 2).amend(fwd),
                        mesh)
    opt = jt.OptimizeVI(lh, n_total_iterations=3, residual_map="smap", kl_map="smap")
    state, pos = tomography_256_start(jt, opt, lh)
    pos = shard_position(pos, mesh)
    slab_maps = (cf.dists[0].shape, cf.dists[0].nb, cf.rowbins[0].nb)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bg.reset_launch_counts()
    li.reset_launch_counts()
    coll.reset_counts()
    mesh.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smp, state = opt.update(jt.Samples(pos=pos), state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts, k11, slab_k11 = launch_counts(bg), los_counts(), slab_counts()
    colls, nbytes, stats = dict(coll.COUNTS), dict(coll.BYTES), dict(mesh.stats)
    finite = all(bool(torch.isfinite(x).all())
                 for x in tree_leaves(smp.pos) + tree_leaves(smp._samples))
    whole = gather_samples(smp, mesh)
    if mesh.is_root:
        for name, tree in (("pos", whole.pos), ("samples", whole._samples)):
            for k, v in tree.items():
                np.save(os.path.join(out_dir, f"{tag}_{name}_{k}.npy"), v.cpu().numpy())
    slab = los.slab(torch.float64)
    return dict(seconds_update=secs, energy=float(state.minimization_state.fun),
                newton=int(state.minimization_state.nit), peak_gib=peak, counts=counts,
                k11=k11, slab_k11=slab_k11, collectives=colls, collective_bytes=nbytes,
                stats=stats, finite=finite, digest=digest_tree((whole.pos, whole._samples)),
                slab_maps=slab_maps, rows=slab.rows, groups=slab.groups, n_virtual=slab.n_virtual)


def mesh_icr_4100(jt, samples, tag):
    """Phase 45: phase 19's 4100^2 chart, data and start (key 7, position
    1) with the samples over a `samples` x 1 mesh under
    `deterministic_reductions`, the maps left at "auto" (the sample loop
    there): one update at `MESH_ICR_KWARGS`; s/update, peak memory, K9's
    launches by (level,
    rows) on this rank (fails unless both K9 kernels launched at every
    level), the collectives, the whole samples' digest."""
    from nifty_tpu_torch.ops import icr_refine as ir
    from nifty_tpu_torch.parallel import collectives as coll
    from nifty_tpu_torch.parallel import gather_samples, make_mesh, shard_position

    jt.config.update("deterministic_reductions", True)
    mesh = make_mesh(samples, 1)
    t0 = time.perf_counter()
    gp = jt.RefinementField(chart_4100(jt), matern32())
    _, response = masked_signal(jt, gp, int(np.prod(gp.chart.shape)), DEMO9_MASK_SEED)
    lh, _ = icr_gaussian(jt, response, jt.HostKey(19), 19, DEMO9_NOISE)
    lh = shard_position(lh, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    opt, smp, state = start(jt, lh, MESH_ICR_KWARGS)
    smp = jt.Samples(pos=shard_position(smp.pos, mesh))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ir.reset_launch_counts()
    coll.reset_counts()
    mesh.stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smp, state = opt.update(smp, state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = icr_counts()
    require_icr_launches(f"45 {tag}", counts, gp)
    whole = gather_samples(smp, mesh)
    return dict(seconds_update=secs, build_s=build_s, energy=float(state.minimization_state.fun),
                peak_gib=peak, counts=counts, collectives=dict(coll.COUNTS),
                stats=dict(mesh.stats), auto_maps=(opt.lockstep, opt.kl_map),
                levels=[lv.key for lv in gp.levels],
                digest=digest_tree((whole.pos, whole._samples)))


def nccl_mesh_shape():
    """The NCCL world's mesh: every card a rank, field-sharded over two
    cards or fewer, else two samples ranks times the rest."""
    n = torch.cuda.device_count()
    return (1, n) if n <= 2 else (2, n // 2)


def mesh_world_cases(ckpt_dir, data_file, out_dir, world, tomo):
    """The cases of the 4-rank gloo world on one card (``world="gloo"``) or
    of the NCCL world over every card (``"nccl"``, one rank a card);
    `tomo`: phase 44's data file and noise."""
    data_256, noise_256 = tomo
    if world == "gloo":
        return [
            ("37 transforms", "mesh_transforms", dict(samples=2, field=2)),
            ("37 kernels", "mesh_kernels", dict(samples=2, field=2)),
            ("37 pairwise 4", "mesh_pairwise", dict(samples=4)),
            ("37 pairwise 2", "mesh_pairwise", dict(samples=2)),
            ("38 demo 4", "mesh_demo4", dict(samples=2, field=2)),
            ("40 write", "mesh_checkpoint_write", dict(samples=2, field=2, odir=ckpt_dir)),
            ("40 resume 4x1", "mesh_checkpoint_resume",
             dict(samples=4, field=1, src=os.path.join(ckpt_dir, "last_ckpt"),
                  odir=os.path.join(ckpt_dir, "resume_4x1"))),
            ("39 update", "mesh_update_4096", dict(samples=2, field=2, data_file=data_file,
                                                   out_dir=out_dir, tag="2x2")),
            ("44 tomography", "mesh_tomography_256",
             dict(samples=2, field=2, data_file=data_256, noise_std=noise_256, out_dir=out_dir,
                  tag="tomo_2x2")),
            ("45 icr", "mesh_icr_4100", dict(samples=4, tag="4x1")),
        ]
    # (beside the gloo world: phase 40's resume last, after the gloo world
    # wrote its checkpoint; phase 45 while that world runs phase 39, which
    # holds the least memory of its full-width updates)
    samples, field = nccl_mesh_shape()
    return [
        ("37 transforms", "mesh_transforms", dict(samples=samples, field=field)),
        ("37 pairwise 1", "mesh_pairwise", dict(samples=samples)),
        ("39 update", "mesh_update_4096", dict(samples=samples, field=field, data_file=data_file,
                                               out_dir=out_dir, tag="nccl")),
        ("45 icr", "mesh_icr_4100", dict(samples=samples * field, tag="nccl")),
        ("44 tomography", "mesh_tomography_256",
         dict(samples=samples, field=field, data_file=data_256, noise_std=noise_256,
              out_dir=out_dir, tag="tomo_nccl")),
        ("40 resume", "mesh_checkpoint_resume",
         dict(samples=samples, field=field, src=os.path.join(ckpt_dir, "last_ckpt"),
              odir=os.path.join(ckpt_dir, "resume_nccl"), writers=4)),
    ]


def mesh_maps(jt, cf4096, cf256):
    """The maps the mesh phases launch the distributor on (this rank's rows
    of the full-grid map, the whole map, and their (row, bin) maps: phase
    6's 4096^2 field, demo 4's and phase 27's 256^3 one), as phase 3 holds
    them; a field rank other than the first has maps of the same shapes."""
    from nifty_tpu_torch.ops import bin_gather as bg

    out = {}
    for label, field in (("4096^2 nb128", cf4096), ("64 x 32", demo4_field(jt, None)),
                         ("256^3 nb128", cf256)):
        hg = field.target_grids[0].harmonic_grid
        full, nb = np.asarray(hg.power_distributor), field.dists[0].nb
        half = full[:full.shape[0] // 2]
        for name, idx in (("full", full), ("slab", half)):
            out[f"{label} {name}"] = bg.BinIndex(idx, nb=nb).cuda()
            out[f"{label} {name} rows x bins"] = bg.row_bin_index(idx, nb).cuda()
    return out


#: rows the mesh phases give each map (see `mesh_world_cases`): phases 39,
#: 40 and 44's sample loops one; phase 38's lockstep draw of a key a rank
#: one, its stacked KL metric two (four and eight held too)
MESH_MAP_ROWS = {
    "4096^2 nb128 full": (1,), "4096^2 nb128 slab": (1,),
    "4096^2 nb128 full rows x bins": (1,), "4096^2 nb128 slab rows x bins": (1,),
    "64 x 32 full": (1, 2, 4, 8), "64 x 32 full rows x bins": (1, 2, 4, 8),
    "64 x 32 slab": (1, 2, 4, 8), "64 x 32 slab rows x bins": (1, 2, 4, 8),
    "256^3 nb128 full": (1,), "256^3 nb128 slab": (1,),
    "256^3 nb128 full rows x bins": (1,), "256^3 nb128 slab rows x bins": (1,),
}


def _same_samples(out_dir, a, b):
    """The largest difference of the two worlds' saved samples and
    positions."""
    worst = 0.0
    for f in sorted(os.listdir(out_dir)):
        if f.startswith(a + "_"):
            x = np.load(os.path.join(out_dir, f), mmap_mode="r")
            y = np.load(os.path.join(out_dir, b + f[len(a):]), mmap_mode="r")
            worst = max(worst, float(np.abs(x - y).max()))
    return worst


def phase_mesh(jt, tmp, data_file, phase6_energy, smi_line, tomo):
    """Phases 37-40, 44 and 45 (see the module docstring): the 4-rank gloo
    world on card 0 and the NCCL world over every card, at once; returns
    the kernels' counts of each run.  `tomo`: phase 44's data file and
    noise, and phase 27's first KL energy."""
    from concurrent.futures import ThreadPoolExecutor

    from nifty_tpu_torch.parallel import run_world

    ckpt, out = os.path.join(tmp, "ckpt"), os.path.join(tmp, "out")
    os.makedirs(ckpt)
    os.makedirs(out)
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()

    def world_run(world, n):
        t0 = time.perf_counter()
        ranks = run_world(mesh_rank, n, args=(mesh_world_cases(ckpt, data_file, out, world,
                                                                tomo[:2]),),
                          backend=world, device="cuda", timeout=600, collective_timeout=300)
        return ranks, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = {world: pool.submit(world_run, world, n)
                for world, n in (("gloo", 4), ("nccl", n_cards))}
        done = {world: job.result() for world, job in jobs.items()}
    for world, (ranks, secs) in done.items():
        how = ("one a card" if world == "nccl" else
               "sharing card 0, collectives through its memory (CUDA IPC) and gloo barriers")
        print(f"mesh world {world}: {len(ranks)} ranks ({how}) {secs:.3f} s with the start of "
              f"its processes | {smi_line}", flush=True)
    print(f"mesh worlds together (the NCCL world beside the gloo world on the card): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    worlds = {world: ranks for world, (ranks, _) in done.items()}
    g, nc = worlds["gloo"][0], worlds["nccl"][0]
    nccl = "nccl {} x {}".format(*nccl_mesh_shape())
    seconds = {w: {name: round(v["seconds"], 3) for name, v in ranks[0].items()}
               for w, ranks in worlds.items()}

    # 37: the transforms, the kernels on the ranks' maps, the fixed-order mean
    for w, res in (("gloo 2 x 2", g["37 transforms"]), (nccl, nc["37 transforms"])):
        errs = {k: v for k, v in res.items() if isinstance(v, dict)}
        print(f"37 {w}: distributed transforms against the whole field's on one rank, max "
              f"|difference| / max |whole|: {json.dumps(errs)} | 4096^2 pencil Hartley "
              f"{res['hartley 4096^2 ms']:.3f} ms a call (one rank's whole-field hartley "
              f"{res['hartley 4096^2 local ms']:.3f} ms)", flush=True)
        bad = {k: e for k, e in errs.items() if max(e.values()) > 1e-10}
        if bad:
            raise AssertionError(f"37 {w}: the distributed transforms disagree: {res}")
    kern = [r["37 kernels"] for r in worlds["gloo"]]
    print(f"37 kernels on each rank's maps (slab, rows x bins {kern[0]['map']}): gather bitwise "
          f"{[k['gather'] for k in kern]}, segment sums' error of sum|cot| "
          f"{[(k['segment sum'], k['rows x bins segment sum']) for k in kern]}", flush=True)
    if not all(k["gather"] for k in kern) or max(
            max(k["segment sum"], k["rows x bins segment sum"]) for k in kern) > 1e-12:
        raise AssertionError(f"37: a distributor kernel disagrees on a rank's map: {kern}")
    print(f"37 K11's slab route on each rank's rows {[k['K11 slab rows'] for k in kern]} of the "
          f"256^3 grid (phase 44's rays): the ray values gathered from the (ray, row) partials "
          f"and the slab adjoint against the whole grid's plain versions, error of sum|term| "
          f"{[(k['K11 slab forward'], k['K11 slab adjoint']) for k in kern]}", flush=True)
    if max(max(k["K11 slab forward"], k["K11 slab adjoint"]) for k in kern) > LOS_RTOL[
            torch.float64]:
        raise AssertionError(f"37: K11's slab route disagrees with the whole grid's: {kern}")
    digests = {f"{n} ranks": g[f"37 pairwise {n}"]["digest"] for n in (4, 2)}
    digests.update({"1 rank": g["37 pairwise 4"]["one"], nccl: nc["37 pairwise 1"]["digest"]})
    print(f"37 pairwise_mean of 8 rows over 1, 2 and 4 ranks: {digests} | "
          f"{g['37 pairwise 4']['stats']}", flush=True)
    if len(set(digests.values())) != 1:
        raise AssertionError(f"37: pairwise_mean's bits depend on the world: {digests}")
    print(f"[phase] 37 the mesh on the card: {seconds['gloo']['37 transforms']} + "
          f"{seconds['gloo']['37 kernels']} s (gloo 2 x 2), {seconds['nccl']['37 transforms']} s "
          f"({nccl})", flush=True)

    # 38: demo 4
    d4 = g["38 demo 4"]
    gate = DEMO4_JAX_RMS * DEMO4_RMS_MARGIN
    print(f"38 demos/4_multichip.py on 2 x 2 (64 x 32, 4 iterations): KL energies "
          f"{[f'{e:.4e}' for e in d4['energies']]} | posterior-mode RMS error {d4['rms']:.4f} "
          f"(noise 0.1; the JAX demo on 4 virtual CPU devices {DEMO4_JAX_RMS}, gate {gate:.4f}) | "
          f"launches by map: {maps_text(d4['counts'])}", flush=True)
    if not d4["rms"] <= gate:
        raise AssertionError(f"38: posterior-mode RMS error {d4['rms']} above {gate}")
    require_launches("38 demo 4", d4["counts"])
    print(f"[phase] 38 demos/4_multichip.py, 2 x 2: {seconds['gloo']['38 demo 4']} s", flush=True)

    # 39: the 4096^2 update
    stages = {w: worlds[w][0]["39 update"]["stages"] for w in worlds}
    for w, r in (("gloo 2 x 2", g["39 update"]), (nccl, nc["39 update"])):
        ranks = worlds["gloo" if w.startswith("gloo") else "nccl"]
        print(f"39 {w}: s/update {r['seconds_update']:.3f}"
              + (" (four ranks share one card: not a scaling figure)" if w.startswith("gloo")
                 else "") + f" | KL energy {r['energy']!r} ({(r['energy'] - phase6_energy) / phase6_energy:+.3e} "
              f"from phase 6's {phase6_energy!r}: fixed-trip solvers and fixed-order sums) | "
              f"Newton steps {r['newton']} | peak GiB per rank "
              f"{[round(x['39 update']['peak_gib'], 3) for x in ranks]} | collectives a rank: "
              f"{r['collectives']} bytes of their inputs {r['collective_bytes']} | sample "
              f"reductions {r['stats']} | launches a rank by map: {maps_text(r['counts'])} | "
              f"slab noise (whole leaves drawn, rows kept) {r['noise_draw_s']} s | "
              f"{smi_line}", flush=True)
        require_launches(f"39 {w}", r["counts"])
    same_stages = stages["gloo"] == stages["nccl"]
    bitwise = g["39 update"]["digest"] == nc["39 update"]["digest"]
    diff = 0.0 if bitwise else _same_samples(out, "2x2", "nccl")
    e2, e1 = g["39 update"]["energy"], nc["39 update"]["energy"]
    print(f"39 gloo 2 x 2 against {nccl}: stages (energy, metric matvec, 20-step CG draw) "
          f"bitwise {same_stages} {stages['gloo']} | update bitwise {bitwise}, samples max "
          f"|difference| {diff!r}, KL energy relative {abs(e2 - e1) / abs(e1)!r}", flush=True)
    if not same_stages or diff > 1e-9 or abs(e2 - e1) > 1e-9 * abs(e1):
        raise AssertionError(f"39: the gloo 2 x 2 world and the {nccl} world disagree")
    print(f"[phase] 39 4096^2 n_bins=128 geoVI update, field- and sample-sharded: "
          f"{seconds['gloo']['39 update']} s (gloo 2 x 2), {seconds['nccl']['39 update']} s "
          f"({nccl})", flush=True)

    # 40: the sharded checkpoint
    w40, r4, rn = g["40 write"], g["40 resume 4x1"], nc["40 resume"]
    print(f"40 optimize_kl(checkpoint_format='orbax') on 2 x 2, files {w40['files']} | third "
          f"iteration in memory {w40['energy']!r} {w40['digest']}, resumed on 4 x 1 "
          f"{r4['energy']!r} {r4['digest']}, on {nccl} {rn['energy']!r} {rn['digest']} (after "
          f"waiting {rn['waited']:.3f} s for the checkpoint)", flush=True)
    print(f"40 the maps on 2 x 2: 'auto' lockstep, kl_map {w40['auto_maps']}; 'vmap' refused "
          f"{w40['vmap_refused']}", flush=True)
    if w40["auto_maps"] != (False, "smap") or not w40["vmap_refused"]:
        raise AssertionError("40: 'auto' must loop over samples and 'vmap' raise on 2 x 2 "
                             "under deterministic_reductions on the card")
    if not (w40["nit"] == r4["nit"] == rn["nit"] == 3
            and w40["digest"] == r4["digest"] == rn["digest"]
            and w40["energy"] == r4["energy"] == rn["energy"]):
        raise AssertionError("40: a resumed iteration differs from the one continued in memory")
    for label, c in (("40 2 x 2", w40["counts"]), ("40 4 x 1", r4["counts"]),
                     (f"40 {nccl}", rn["counts"])):
        require_launches(label, c)
    print(f"[phase] 40 the sharded checkpoint: {seconds['gloo']['40 write']} + "
          f"{seconds['gloo']['40 resume 4x1']} s (gloo), {seconds['nccl']['40 resume']} s "
          f"({nccl})",
          flush=True)
    mesh_tomography_report(worlds, nccl, tomo[2], seconds, smi_line)
    mesh_icr_report(worlds, nccl, seconds, smi_line)
    return {"demo4": d4["counts"], "mesh_4096_2x2": g["39 update"]["counts"],
            **{f"tomography_2x2_rank{r}": worlds["gloo"][r]["44 tomography"]["counts"]
               for r in range(4)},
            "tomography_nccl": nc["44 tomography"]["counts"],
            **{f"k11_tomography_2x2_rank{r}": worlds["gloo"][r]["44 tomography"]["k11"]
               for r in range(4)},
            "k11_tomography_nccl": nc["44 tomography"]["k11"],
            **{f"slab_tomography_2x2_rank{r}": worlds["gloo"][r]["44 tomography"]["slab_k11"]
               for r in range(4)},
            "slab_tomography_nccl": nc["44 tomography"]["slab_k11"],
            "icr_4x1": g["45 icr"]["counts"], "icr_nccl": nc["45 icr"]["counts"],
            "mesh_4096_nccl": nc["39 update"]["counts"], "checkpoint_2x2": w40["counts"],
            "checkpoint_4x1": r4["counts"], "checkpoint_nccl": rn["counts"]}


def mesh_tomography_report(worlds, nccl, e27, seconds, smi_line):
    """Phase 44's lines and gates: every rank's latents finite, both worlds
    bitwise equal (the whole samples' digest and the KL energy), and on
    every rank K11 launched on its slab tables (both directions) and both
    distributor kernels on its slab's maps."""
    for w, label in (("gloo", "gloo 2 x 2"), ("nccl", nccl)):
        ranks = [r["44 tomography"] for r in worlds[w]]
        r = ranks[0]
        print(f"44 {label}: s/update {r['seconds_update']:.3f}"
              + (" (four ranks share one card: not a scaling figure)" if w == "gloo" else "")
              + f" | KL energy {r['energy']!r} ({(r['energy'] - e27) / e27:+.3e} from phase 27's "
              f"first update without a mesh, {e27!r}: fixed-trip solvers and fixed-order sums; "
              f"reported, not gated) | Newton steps {r['newton']} | peak GiB per rank "
              f"{[round(x['peak_gib'], 3) for x in ranks]} | collectives a rank: "
              f"{r['collectives']} bytes of their inputs {r['collective_bytes']} | sample "
              f"reductions {r['stats']} | slab rows per rank {[x['rows'] for x in ranks]}, "
              f"{r['n_virtual']} virtual rays by lanes {r['groups']} | {smi_line}", flush=True)
        for i, x in enumerate(ranks):
            print(f"44 {label} rank {i}: K11 launches by (table, rows): {los_text(x['k11'])}; "
                  f"los_slab_forward {slab_text(x['slab_k11'])} | "
                  f"distributor launches by map (slab {x['slab_maps']}): "
                  f"{maps_text(x['counts'])}", flush=True)
            if not x["finite"]:
                raise AssertionError(f"44 {label}: a latent of rank {i} is not finite")
            # the gather on the slab's rows of the map, the segment sum on
            # their (row, bin) map (`deterministic_reductions`); K11 on the
            # slab's tables in both directions
            shape, nb, nb_rows = x["slab_maps"]
            for kind, bins in (("gather", nb), ("segsum", nb_rows)):
                if sum(c for (shape_, nb_, _), c in x["counts"][f"{kind}_by_map"].items()
                       if (shape_, nb_) == (shape, bins)) <= 0:
                    raise AssertionError(f"44 {label} rank {i}: {kind} never launched on the "
                                         f"slab's map {shape}, {bins} bins: {x['counts']}")
            if sum(n for ((shape_, _, _), _), n in x["k11"]["adjoint"].items()
                   if shape_ == shape) <= 0:
                raise AssertionError(f"44 {label} rank {i}: the K11 adjoint never launched on "
                                     f"the slab's table {shape}: {x['k11']}")
            if sum(n for ((_, rows, _), _), n in x["slab_k11"].items() if rows == x["rows"]) <= 0:
                raise AssertionError(f"44 {label} rank {i}: los_slab_forward never launched on "
                                     f"the slab's rows {x['rows']}: {x['slab_k11']}")
    g, nc = worlds["gloo"][0]["44 tomography"], worlds["nccl"][0]["44 tomography"]
    bitwise = g["digest"] == nc["digest"] and g["energy"] == nc["energy"]
    print(f"44 gloo 2 x 2 against {nccl}: samples' digest {g['digest']} / {nc['digest']}, KL "
          f"energy {g['energy']!r} / {nc['energy']!r}: bitwise {bitwise}", flush=True)
    if not bitwise:
        raise AssertionError(f"44: the gloo 2 x 2 world and the {nccl} world differ")
    print(f"[phase] 44 256^3 tomography geoVI update, field- and sample-sharded: "
          f"{seconds['gloo']['44 tomography']} s (gloo 2 x 2), "
          f"{seconds['nccl']['44 tomography']} s ({nccl})", flush=True)


def mesh_icr_report(worlds, nccl, seconds, smi_line):
    """Phase 45's lines and gates: 'auto' looped over samples, and the two
    worlds bitwise equal (each rank failed already unless K9 launched at
    every level)."""
    for w, label in (("gloo", "gloo 4 x 1"), ("nccl", nccl)):
        ranks = [r["45 icr"] for r in worlds[w]]
        r = ranks[0]
        print(f"45 {label}: field built in {[round(x['build_s'], 3) for x in ranks]} s | s/update "
              f"{r['seconds_update']:.3f} | KL energy {r['energy']!r} | peak GiB per rank "
              f"{[round(x['peak_gib'], 3) for x in ranks]} | 'auto' lockstep, kl_map "
              f"{r['auto_maps']} | collectives a rank {r['collectives']} | sample reductions "
              f"{r['stats']} | {smi_line}", flush=True)
        for i, x in enumerate(ranks):
            print(f"45 {label} rank {i}: K9 launches by (level, rows): "
                  + "; ".join(f"{kind} " + ", ".join(f"{key[0]} B={b}: {n}"
                                                     for (key, b), n in sorted(c.items()))
                              for kind, c in x["counts"].items()), flush=True)
            if x["auto_maps"] != (False, "smap"):
                raise AssertionError(f"45 {label}: 'auto' must loop over samples on the card "
                                     "under deterministic_reductions with a mesh")
    g, nc = worlds["gloo"][0]["45 icr"], worlds["nccl"][0]["45 icr"]
    bitwise = g["digest"] == nc["digest"] and g["energy"] == nc["energy"]
    print(f"45 gloo 4 x 1 against {nccl}: samples' digest {g['digest']} / {nc['digest']}, KL "
          f"energy {g['energy']!r} / {nc['energy']!r}: bitwise {bitwise}", flush=True)
    if not bitwise:
        raise AssertionError(f"45: the gloo 4 x 1 world and the {nccl} world differ")
    print(f"[phase] 45 4100^2 ICR geoVI update, sample-sharded: {seconds['gloo']['45 icr']} s "
          f"(gloo 4 x 1), {seconds['nccl']['45 icr']} s ({nccl})", flush=True)


def profile_update(jt, label, lh, top=12, **maps):
    """One warm-up update from bench.py's start, then one under
    :func:`profile_window`."""
    opt, samples, state = start(jt, lh, BENCH_KWARGS, **maps)
    samples, state = opt.update(samples, state)
    profile_window(label, lambda: kl_text(opt.update(samples, state)), top)


def kl_text(update):
    """The KL energy of an `OptimizeVI.update`'s `(samples, state)`."""
    return f"KL energy {float(update[1].minimization_state.fun)!r}"


def profile_window(label, run, top=12, sums=None):
    """`run()` (one `OptimizeVI.update`, or one evidence estimate; it
    returns a text to print) under ``torch.profiler``: its wall time
    (inflated by the profiler), the summed device time of its kernels and
    the device's busy share, the kernel launches, the costliest kernels;
    and for each entry of `sums` ({label: name parts}) the device time and
    calls of the kernels whose names hold one of its parts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        text = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(evt):
        t = getattr(evt, "self_device_time_total", None)
        return evt.self_cuda_time_total if t is None else t

    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(device_us(e) for e in kernels) / 1e6
    print(f"profile {label}: {wall:.3f} s under the profiler | device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f} %) | "
          f"{sum(e.count for e in kernels)} kernel launches | {text}", flush=True)
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:7d} x  {e.key[:100]}", flush=True)
    for what, parts in (sums or {}).items():
        hits = [e for e in kernels if any(part in e.key for part in parts)]
        print(f"  {what}: {sum(device_us(e) for e in hits) / 1e3:.3f} ms over "
              f"{sum(e.count for e in hits)} calls", flush=True)


def kernel_entries(kres, paths, src, dtype="float64"):
    """The `kernels` line: one entry for each kernel, map and number of rows
    that the runs in `paths` launched on `dtype` values, with phase 3's
    numbers (`kres`) for that shape and type; fails on a shape that phase 3
    did not check."""
    kernels = []
    for grid, dist, tpu_gather, tpu_segsum, runs in paths:
        for name, kind, (k, replaces) in (("bin_gather", "gather", tpu_gather),
                                          ("bin_segment_sum", "segsum", tpu_segsum)):
            by_rows = {run: on_map(c, f"{kind}_by_map", dist) for run, c in runs.items()}
            kernels_by_rows = [on_map(c, f"{kind}_kernels_by_map", dist) for c in runs.values()]
            for nrows in sorted(set().union(*by_rows.values())):
                label = f"{grid} B={nrows}"
                if (label, dtype) not in kres:
                    raise AssertionError(
                        f"the main path launched {name} at {label} in {dtype}, a shape that "
                        f"phase 3 did not hold against the plain version")
                r = kres[(label, dtype)]
                counted = [(c[nrows], k[nrows]) for c, k in zip(by_rows.values(), kernels_by_rows)
                           if c.get(nrows)]
                # launches: calls of the wrapper with this many rows in the
                # first run that made any (launches_by_run: in each run);
                # kernel_launches: the kernels those calls launched, summed
                # from their C entries' return values in that run.  ms,
                # plain_ms, library_ms: device times (CUDA-graph replay);
                # host_ms, plain_host_ms: host-paced.
                kernels.append(dict(
                    name=f"{name} ({k}, {label}, {dtype})", route="cuda", source=src,
                    replaces=replaces, launches=counted[0][0],
                    kernel_launches=counted[0][1],
                    launches_by_run={run: c.get(nrows, 0) for run, c in by_rows.items()},
                    max_abs_err=r[f"{kind}_err"],
                    ms=r[f"{kind}_device_ms"], plain_ms=r[f"{kind}_plain_device_ms"],
                    bound_ms=r[f"{kind}_bound_ms"], bound_by=r[f"{kind}_bound_by"],
                    library_ms=r[f"{kind}_library_device_ms"],
                    host_ms=r[f"{kind}_ms"], plain_host_ms=r[f"{kind}_plain_ms"],
                ))
    return kernels


def side_phases():
    """Phases 29-31 (demos 5, 8 and 15) in a process of their own, with the
    card set up as :func:`phase_device` sets it and the kernels that
    :func:`phase_build` built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import nifty_tpu_torch as jt

    jt.logger.setLevel(logging.WARNING)
    phase_demo5(jt)
    phase_demo8(jt)
    phase_demo15(jt)


def main(argv):
    """``--profile``: after phases 5, 6, 8, 12, 15, 19, 23, 24, 27 and 35, profile
    one more update of each config, and after phase 33 one more SLQ probe
    at 4096^2 (device busy share and the costliest kernels).  ``--witness``:
    run phase 23's fit once more with K10 replaced
    by its ``torch.fft`` route, and print that fit's KL energy beside the
    kernel's."""
    with_profile = "--profile" in argv
    with_witness = "--witness" in argv
    smi_line = phase_device()
    optional_libraries()
    import nifty_tpu_torch as jt

    jt.logger.setLevel(logging.WARNING)
    builds = start_builds()

    # the correlated fields' host set-up (mode maps, CSR), which calls no
    # kernel, while the kernels compile
    t0 = time.perf_counter()
    cf128 = build_field(jt, (128, 128))
    cf1024 = build_field(jt, (1024, 1024))
    cf4096 = build_field(jt, (4096, 4096), n_bins=128)
    t1 = time.perf_counter()
    cf4096u = build_field(jt, (4096, 4096))
    t2 = time.perf_counter()
    # phase 12's field: 512^2 unbinned (22,026 bins, full-grid map) x 64
    # channels (33 bins); phase 11's: 64 pixels (33 bins) x 16 channels (9)
    cf512 = build_multifrequency(jt, (512, 512), 64)
    map512, map64 = cf512.dists
    map16 = build_multifrequency(jt, (64,), 16).dists[1]
    # phase 16's map: the Matern field of `density_estimator(128, 1/128)` on
    # its padded 256-entry grid (129 bins, uint8 index)
    map256 = jt.density_estimator(128, 1.0 / 128)[0].field.dist
    t3 = time.perf_counter()
    phase_build(builds)
    waited = time.perf_counter() - t3
    # phase 23's sky: HEALPix nside 256, lmax 511 (the Legendre table, 2.15 GB
    # in float64, and the ring table); its l map (262,144 modes, 512 bins)
    sky = build_sphere(jt, 511, "healpix")
    sky_sht = sky.spherical_transform.sht
    t4 = time.perf_counter()
    # phases 26-28's tomography models (their ray tables and data): demo 1's
    # 64^3 (unbinned full-grid map), its 256^3 at scale (n_bins=128: the
    # 129^3 quarter map) and the NUTS cross-check's 16^3
    lh64, cf64, los64, _ = build_tomography(jt, (64,) * 3, 128, 128, 5, DEMO1_SEED,
                                            flexible=False)
    lh256, cf256, los256, noise256 = build_tomography(jt, key=DEMO1_SEED, n_bins=128,
                                                      **TOMO256_RAYS)
    lh16, cf16, los16, noise16 = build_tomography(jt, (16,) * 3, 48, 64, NUTS_SEED,
                                                  NUTS_SEED + 1)
    # phase 32's map: demo 11's 64^2 fields (both models share it)
    map64sq = demo11_field(jt, True, "true").dist
    # phase 41's map: demo 7's 64^2 field, checked in phase 3 on its own
    # where it is not demo 11's map
    map7 = demo7_field(jt).dist
    same7 = (map7.shape, map7.nb) == (map64sq.shape, map64sq.nb)
    # phases 37-40's maps: a field rank's rows of phase 6's full-grid map and
    # of demo 4's, the whole maps, and their (row, bin) maps
    mmaps = mesh_maps(jt, cf4096, cf256)
    print(f"field set-up (host mode maps, CSR) {time.perf_counter() - t0 - waited:.3f} s "
          f"(the kernels compiling meanwhile, {waited:.3f} s waited for after it), of which 4096^2 "
          f"unbinned {t2 - t1:.3f} s, 512^2 x 64 {t3 - t2:.3f} s, the HEALPix sky (nside "
          f"{sky_sht.nside}, {sky_sht.nrings} rings, Legendre table "
          f"{sky_sht.lam.numel() * 8 / 2**30:.2f} GiB) {t4 - t3 - waited:.3f} s, the tomography "
          f"models "
          f"(ray tables, data; 256^3: the {cf256.dist.shape} quarter map) "
          f"{time.perf_counter() - t4:.3f} s", flush=True)
    # the 1-D maps at the rows the lockstep stages give them (1 for an
    # unbatched call, 4 for the draw of 4 keys, 8 for the curve and the
    # stacked KL stage of 8 samples) and at those rows times total_N = 3
    # (12 and 24)
    small_maps = {f"{label} B={rows}": (dist, rows)
                  for label, dist in (("16 (1-D)", map16), ("64 (1-D)", map64))
                  for rows in (1, 4, 8, 12, 24)}
    # ... and the 256-entry map at the rows of phase 16's 2 pairs: 1 for a
    # model call, 2 for the lockstep draw, 4 for the curve and the KL stage
    small_maps.update({f"256 (1-D) B={rows}": (map256, rows) for rows in (1, 2, 4)})
    # ... and the l map of phases 23 and 24 (lmax 511) at 1 row for a model
    # call and 2, 4 and 8 for stacked samples
    small_maps.update({f"l map lmax 511 B={rows}": (sky.dist, rows) for rows in (1, 2, 4, 8)})
    kres = phase_kernels({
        "4096^2 nb128 quarter B=1": (cf4096.dist, 1),
        # an odd-length map: the second row starts misaligned
        "4096^2 nb128 quarter B=2": (cf4096.dist, 2),
        # 128^2: one row for an unbatched model call, 2 and 4 for the
        # lockstep draw of 2 and 4 keys, 4 and 8 for the curve and the
        # stacked KL stage of 4 and 8 samples
        "128^2 unbinned B=1": (cf128.dist, 1),
        "128^2 unbinned B=2": (cf128.dist, 2),
        "128^2 unbinned B=4": (cf128.dist, 4),
        "128^2 unbinned B=8": (cf128.dist, 8),
        # 82,799 modes on the 513^2 quarter map: int32 index, a table above
        # the 227 KB a block can hold, a warp item per bin
        "1024^2 unbinned quarter B=1": (cf1024.dist, 1),
        "1024^2 unbinned quarter B=8": (cf1024.dist, 8),
        # 1,197,363 modes on the 2049^2 quarter map: a 9.6 MB table a
        # float64 row, every class of short bins, 9 bins of 33 to 40 entries
        # as block items
        "4096^2 unbinned quarter B=1": (cf4096u.dist, 1),
        **small_maps,
        # 22,026 modes on the full 512^2 map: int16 index, a 176 KB table a
        # float64 row
        "512^2 unbinned B=1": (map512, 1),
        # the tomography maps: 16^3 and 64^3 unbinned full-grid maps at the
        # rows of a model call (1), the lockstep draw of 4 keys (4) and the
        # stacked KL stage of 8 samples (8); 256^3's 129^3 quarter map
        # (2,146,689 entries, 128 bins) at 1 and, misaligned, 2 rows
        **{f"{n}^3 unbinned B={rows}": (dist, rows)
           for n, dist in ((16, cf16.dist), (64, cf64.dist)) for rows in (1, 4, 8)},
        "256^3 nb128 quarter B=1": (cf256.dist, 1),
        "256^3 nb128 quarter B=2": (cf256.dist, 2),
        # demo 11's 64^2 full-grid map at the rows of a model call and an
        # ARPACK matvec (1), the lockstep draw of 2 keys (2) and the curve
        # and the stacked KL stage of 4 samples (4)
        **{f"64^2 unbinned B={rows}": (map64sq, rows) for rows in (1, 2, 4)},
        # demo 7's, where it differs, at the rows of a model call (1), the
        # lockstep draw of 1 and 2 keys and the KL stage of 2 and 4 samples
        **({} if same7 else {f"64^2 demo 7 B={rows}": (map7, rows) for rows in (1, 2, 4)}),
        # the mesh phases' maps at the rows they give them (MESH_MAP_ROWS),
        # float64, 10 calls a timing (256^3's 3)
        **{f"{label} B={rows}": (mmaps[label], rows, 3 if label.startswith("256^3") else 10)
           for label, all_rows in MESH_MAP_ROWS.items() for rows in all_rows},
    }, f32={
        # phase 43's runs (4096^2 in the sample loop, 128^2 in lockstep, the
        # acceptance run's 64^2 in lockstep) and phase 46's legs (the sample
        # loop or a chain: one row)
        "4096^2 nb128 quarter B=1", *(f"128^2 unbinned B={rows}" for rows in (1, 2, 4, 8)),
        *(f"64^2 unbinned B={rows}" for rows in (1, 2, 4)), "256^3 nb128 quarter B=1",
        "1024^2 unbinned quarter B=1", "l map lmax 511 B=1", "16^3 unbinned B=1"})

    k7_cpu_vs_card = phase_cpu_vs_card(jt)

    lh128 = build_likelihood(jt, cf128, 0)
    # bench.py's maps: 128^2 "vmap" (lockstep residual stages, the KL stage
    # stacks the samples), 4096^2 the sample loop for both stages
    base = torch.cuda.memory_allocated()
    c128, e128, samples128 = phase("5 128^2 unbinned, lockstep, 3 updates")(drive)(
        jt, "128^2 unbinned", lh128, 3, residual_map="vmap")
    peak128 = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"128^2 unbinned: launches with the residual stages in lockstep gather "
          f"{c128['gather']} segment_sum {c128['segsum']}; with the sample loop they were "
          f"{LOOP_COUNTS_128['gather']} / {LOOP_COUNTS_128['segsum']}", flush=True)
    if with_profile:
        profile_update(jt, "128^2 unbinned", lh128, residual_map="vmap")
    c_adaptive = phase_adaptive(jt, lh128, e128)
    lh4096 = build_likelihood(jt, cf4096, 0)
    base = torch.cuda.memory_allocated()
    c4096, e4096, samples4096 = phase("6 4096^2 n_bins=128, 1 update")(drive)(
        jt, "4096^2 n_bins=128", lh4096, 1, residual_map="smap", kl_map="smap")
    peak4096 = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    # phase 39's data: phase 6's, read by the ranks of its worlds
    mesh_tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    data_4096 = os.path.join(mesh_tmp, "data_4096.npy")
    np.save(data_4096, lh4096.likelihood.data.cpu().numpy())
    if with_profile:
        profile_update(jt, "4096^2 n_bins=128", lh4096, residual_map="smap", kl_map="smap")
    c_f32 = phase_float32(jt, {
        "128^2 unbinned": (lh128, (128, 128), None, 3, dict(residual_map="vmap"),
                           (e128, peak128)),
        "4096^2 n_bins=128": (lh4096, (4096, 4096), 128, 1,
                              dict(residual_map="smap", kl_map="smap"), (e4096, peak4096))},
        smi_line)
    d = cf1024.dist
    print(f"1024^2 unbinned: {d.nb} modes on the {d.shape} quarter map | index "
          f"{str(d.idx_narrow.dtype).replace('torch.', '')} | float64 table {d.nb * 8} bytes a "
          f"row | segment sum work items {d.n_items} ({d.n_short} short bins, {d.n_split} "
          f"split)", flush=True)
    lh1024 = build_likelihood(jt, cf1024, 0)
    c1024, e1024, _ = phase("8 1024^2 unbinned, 1 update")(drive)(
        jt, "1024^2 unbinned", lh1024, 1, residual_map="smap", kl_map="auto")
    # the spectrum's scan over 82,798 steps must repeat its bits
    _, e1024_again, _ = phase("8 1024^2 unbinned, the same update again")(drive)(
        jt, "1024^2 unbinned again", lh1024, 1, residual_map="smap", kl_map="auto")
    if e1024_again != e1024:
        raise AssertionError(
            f"1024^2 unbinned: two runs of one update end at {e1024!r} and {e1024_again!r}")
    if with_profile:
        profile_update(jt, "1024^2 unbinned", lh1024, residual_map="smap", kl_map="auto")
    del lh1024
    c_loop, e_loop = phase_optimize_kl(jt)
    c_demo7, c_twin = phase_config_file(jt, e_loop)
    d = cf4096u.dist
    print(f"4096^2 unbinned: {d.nb} modes on the {d.shape} quarter map | float64 table "
          f"{d.nb * 8} bytes a row | segment sum work items {d.n_items} ({d.n_short} short bins, "
          f"{d.n_block_items} block items, {d.n_split} split)", flush=True)
    lh4096u = build_likelihood(jt, cf4096u, 0)
    c4096u, _, _ = phase("10 4096^2 unbinned, 1 update")(drive)(
        jt, "4096^2 unbinned", lh4096u, 1, residual_map="smap", kl_map="smap")
    del lh4096u
    c_mf = phase_multifrequency(jt)
    print(f"512^2 x 64: {map512.nb} modes on the {map512.shape} map (index "
          f"{str(map512.idx_narrow.dtype).replace('torch.', '')}) times {map64.nb} on the "
          f"{map64.shape} map | {map512.n * map64.n} field entries", flush=True)
    lh512 = build_likelihood(jt, cf512, 0, noise_std=0.2)
    c512, _, _ = phase("12 512^2 x 64 space x frequency, 1 update")(drive)(
        jt, "512^2 x 64", lh512, 1, residual_map="smap", kl_map="smap", subgrid_maps=cf512.dists)
    if with_profile:
        profile_update(jt, "512^2 x 64", lh512, residual_map="smap", kl_map="smap")
    del lh512
    c_poisson = phase_poisson_counts(jt)
    c_bernoulli_map, c_bernoulli_vi = phase_bernoulli(jt)
    # Poisson counts at grid scale: X-ray and gamma-ray count maps
    lh1024p, _, _ = poisson_likelihood(jt, cf1024, jt.HostKey(0))
    c1024p, _, _ = phase("15 1024^2 unbinned Poisson counts, 1 update")(drive)(
        jt, "1024^2 Poisson counts", lh1024p, 1, residual_map="smap", kl_map="auto")
    if with_profile:
        profile_update(jt, "1024^2 Poisson counts", lh1024p, residual_map="smap", kl_map="auto")
    del lh1024p
    c_density = phase_density(jt)

    # iterative charted refinement: the fields' host precompute, the kernels
    # at every (level, rows) shape phases 18-21 launch (demo 9's lockstep
    # stages give 1, 4 and 8 rows; the sample loop of 19-21 one), then the
    # four cells
    icr = build_icr_fields(jt)
    kres_icr = phase_icr_kernels({
        f"{name} L{lv} B={rows}": (level, rows)
        for name, field in icr.items() for lv, level in enumerate(field.levels)
        for rows in ((1, 2, 4, 8) if name == "demo9" else (1,))},
        # phase 46's float32 legs: phases 19 and 21's fields, the sample loop
        f32={f"{name} L{lv} B=1" for name in ("4100^2", "sphere x radius")
             for lv in range(len(icr[name].levels))})
    c_demo9 = phase_demo9(jt, icr["demo9"])
    c_4100, lh4100, ref4100 = phase_4100(jt, icr["4100^2"], with_profile)
    sphere = icr["sphere nside 256"]
    c_sphere, _ = phase("20 a HEALPix sphere, nside 4 -> 256, Gaussian, 1 update")(drive_icr)(
        jt, "sphere nside 256", build_likelihood(jt, sphere, jt.HostKey(20)), sphere,
        residual_map="smap", kl_map="smap")
    radial = icr["sphere x radius"]
    lh_radial = build_likelihood(jt, radial, jt.HostKey(21))
    c_radial, ref_radial = phase("21 sphere x radius, (48, 6) -> (49152, 68), Gaussian, "
                                 "1 update")(drive_icr)(
        jt, "sphere x radius", lh_radial, radial, residual_map="smap", kl_map="smap")
    npix4100 = int(np.prod(icr["4100^2"].chart.shape))
    f32_icr = phase_icr_float32(jt, {
        "4100^2 deformed chart": (
            icr["4100^2"], lh4100, DEMO9_NOISE, ref4100,
            lambda gp: masked_signal(jt, gp, npix4100, DEMO9_MASK_SEED)[1]),
        "sphere x radius": (radial, lh_radial, NOISE_STD, ref_radial, lambda gp: gp)}, smi_line)
    del lh4100, lh_radial
    torch.cuda.empty_cache()

    # spherical correlated fields: K10 at the rows a model call (1) and
    # stacked samples (2, 4, 8) give it, then the two cells
    hp_rings = sky_sht.rings
    kres_hp = phase_hp_kernels({f"nside 256 mmax 511 B={rows}": (hp_rings, 512, rows)
                                for rows in (1, 2, 4, 8)},
                               {"nside 2048 mmax 511 B=1": (2048, 512, 1)},
                               f32={"nside 256 mmax 511 B=1"})
    c_demo16, k10_demo16, (lh_sky, k_init16, k_opt16, ref16) = phase_demo16(
        jt, sky, with_profile, with_witness)
    f32_sky = phase_sphere_float32(jt, sky, lh_sky, k_init16, k_opt16, ref16, smi_line)
    del sky, sky_sht, lh_sky
    torch.cuda.empty_cache()
    gl = build_bench_sphere(jt, 511)
    lh_gl = build_likelihood(jt, gl, jt.HostKey(24))
    c_gl, _, _ = phase("24 a Gauss-Legendre sphere, lmax 511 (512 x 1024), 1 update")(drive)(
        jt, "Gauss-Legendre sphere lmax 511", lh_gl, 1, residual_map="smap", kl_map="smap")
    if with_profile:
        profile_update(jt, "Gauss-Legendre sphere lmax 511", lh_gl, residual_map="smap",
                       kl_map="smap")
    gl_dist = gl.dist
    del gl, lh_gl
    torch.cuda.empty_cache()

    # line-of-sight tomography: K11 at every (table, rows) shape phases 26-28
    # launch (the lockstep stages give 1, 4 and 8 rows; the sample loop and
    # the chain one), then the three cells
    # and the slab tables of phase 44's worlds (rows 0-127 and 128-255 of
    # a field rank of 2 x 2, the whole grid of 1 x 1) and of a 16^3 slab
    slabs = los_slabs({"256^3": los256, "16^3": los16})
    kres_los = phase_los_kernels({
        **{f"{n}^3 x {los.target.shape[0]} rays B={rows}": (los, rows)
           for n, los in ((16, los16), (64, los64)) for rows in (1, 4, 8)},
        "256^3 x 1024 rays B=1": (los256, 1), **slab_cases(slabs)},
        f32={"256^3 x 1024 rays B=1", "16^3 x 48 rays B=1"})
    sres_los = phase_los_slabs(slabs)
    del slabs
    torch.cuda.empty_cache()
    c_demo1, k11_demo1 = phase_demo1(jt, lh64, cf64)
    del lh64, los64
    c_256, k11_256, e256, ref256 = phase_tomography_256(jt, lh256, cf256, with_profile)
    f32_256 = phase_tomography_float32(jt, lh256, los256, noise256, ref256, smi_line)
    # phase 44's data: phase 27's, read by the ranks of its worlds
    data_256 = os.path.join(mesh_tmp, "data_256.npy")
    np.save(data_256, lh256.likelihood.data.cpu().numpy())
    del lh256, los256
    torch.cuda.empty_cache()
    (c_geo16, k11_geo16), (c_nuts, k11_nuts), (*nuts_start, ref_nuts) = phase_nuts(
        jt, lh16, cf16)
    f32_nuts = phase_nuts_float32(jt, lh16, los16, noise16, nuts_start, ref_nuts, smi_line)

    # inference and diagnostics: demo 11, then the evidence on phase 6's
    # and phase 5's posteriors (demos 5, 8 and 15 run beside the mesh
    # phases, `side_phases`)
    c_demo11, demo11_map = phase_demo11(jt)
    c_ev4096, c_ev128 = phase_evidence(jt, lh4096, samples4096, lh128, samples128, with_profile)
    c_instr = phase_instrumentation(jt, lh4096, samples4096, cf4096, smi_line)
    del lh4096, samples4096
    torch.cuda.empty_cache()

    # radio imaging: K7 at every (plane, rows) shape phases 4 and 35 launch
    # (phase 35's 1024^2 model: 1.0e6 visibilities of 351 baselines x 2849
    # steps, 8 w-planes on 2048^2 grids, the sample loop's one row; phase
    # 4's 32^2 one: its lockstep stages' 2 and 4 rows too) on responses of
    # their own, so that the cell's factor tables are built in its counted
    # run; then the cell, which builds its model, and the new minimizers
    t0 = time.perf_counter()
    rr_radio = radio_response((1024, 1024), 2849)
    rr32 = radio_response((32, 32), 12, n_vis=4000)
    print(f"radio set-up for phase 34 (uv synthesis, host window tables) "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    kres_k7, fres_k7 = phase_k7_kernels({
        **{f"1024^2 radio plane {i} B=1": (rr_radio, p, 1)
           for p, i in enumerate(rr_radio.planes)},
        **{f"32^2 radio plane {i} B={rows}": (rr32, p, rows)
           for p, i in enumerate(rr32.planes) for rows in (1, 2, 4)}},
        f32={f"1024^2 radio plane {i} B=1" for i in rr_radio.planes})
    del rr_radio, rr32
    torch.cuda.empty_cache()
    c_radio, k7_radio, (lh_radio, rr1024, std_radio, ref_radio) = phase_radio(
        jt, cf1024, with_profile)
    f32_radio = phase_radio_float32(jt, lh_radio, rr1024, std_radio, ref_radio, smi_line)
    del lh_radio, rr1024
    torch.cuda.empty_cache()
    c_solvers = phase_solvers(jt, lh128, samples128)
    del lh128, samples128

    # mesh parallelism: a 4-rank gloo world on card 0, then an NCCL world
    # over every card; beside them, in a process of its own, demos 5, 8 and
    # 15 (phases 29-31), which the host-bound worlds leave a core and most
    # of the card for
    side = multiprocessing.get_context("spawn").Process(target=side_phases)
    side.start()
    try:
        c_mesh = phase_mesh(jt, mesh_tmp, data_4096, e4096, smi_line, (data_256, noise256, e256))
    finally:
        shutil.rmtree(mesh_tmp, ignore_errors=True)
        side.join()
    if side.exitcode != 0:
        raise RuntimeError(f"phases 29-31 failed beside the mesh phases (exit {side.exitcode})")

    src = "nifty_tpu_torch/csrc/bin_gather.cu"
    tpu = "nifty_tpu/ops/pallas_gather.py"
    # each map with the TPU kernels its gather and segment sum replace and
    # the main-path runs that launch it (the first is the one `launches`
    # counts).  The unbinned 512^2, 1024^2 and 4096^2 maps are shapes the TPU
    # leaves to its sorted XLA route (K5, `sorted_bin_gather`); the 1-D maps
    # of 16, 64 and 256 entries are K1/K2's (at most 1024 bins).
    k1k2 = ("K1", f"{tpu}:184"), ("K2", f"{tpu}:228")
    k3k4 = ("K3", f"{tpu}:369"), ("K4", f"{tpu}:406")
    k5 = ("K5 route", f"{tpu}:1013"), ("K5 route", f"{tpu}:1013")
    paths = [
        ("4096^2 nb128 quarter", cf4096.dist, *k1k2,
         {"fixed": c4096, "evidence_4096": c_ev4096, "instrumentation_4096": c_instr,
          "mixed": c_f32["mixed 4096^2 n_bins=128"]}),
        ("128^2 unbinned", cf128.dist, *k3k4,
         {"fixed": c128, "mixed": c_f32["mixed 128^2 unbinned"], "adaptive": c_adaptive,
          "optimize_kl": c_loop,
          "poisson_counts": c_poisson, "bernoulli_map": c_bernoulli_map,
          "bernoulli_geovi": c_bernoulli_vi, "evidence_128": c_ev128, "solvers_128": c_solvers,
          "config_twin": c_twin}),
        ("1024^2 unbinned quarter", cf1024.dist, *k5, {"fixed": c1024, "poisson": c1024p,
                                                        "radio_1024": c_radio}),
        ("4096^2 unbinned quarter", cf4096u.dist, *k5, {"fixed": c4096u}),
        ("16 (1-D)", map16, *k1k2, {"multifrequency": c_mf}),
        ("64 (1-D)", map64, *k1k2, {"multifrequency": c_mf, "space_x_frequency": c512}),
        ("512^2 unbinned", map512, *k5, {"space_x_frequency": c512}),
        ("256 (1-D)", map256, *k1k2, {"density": c_density}),
        ("l map lmax 511", gl_dist, *k1k2, {"demo16": c_demo16, "gl_sphere": c_gl}),
        ("64^3 unbinned", cf64.dist, *k3k4, {"demo1": c_demo1}),
        ("256^3 nb128 quarter", cf256.dist, *k1k2, {"tomography_256": c_256}),
        ("16^3 unbinned", cf16.dist, *k3k4, {"nuts_geovi": c_geo16, "nuts": c_nuts}),
        ("64^2 unbinned", demo11_map, *k3k4,
         {"demo11": c_demo11, **({"demo7": c_demo7} if same7 else {}),
          "acceptance": c_f32["acceptance float64"]}),
        *([] if same7 else [("64^2 demo 7", map7, *k3k4, {"demo7": c_demo7})]),
        # the mesh phases' maps: launches a rank (rank 0's run)
        ("4096^2 nb128 slab", mmaps["4096^2 nb128 slab"], *k1k2,
         {"mesh_4096_2x2": c_mesh["mesh_4096_2x2"]}),
        ("4096^2 nb128 slab rows x bins", mmaps["4096^2 nb128 slab rows x bins"], *k1k2,
         {"mesh_4096_2x2": c_mesh["mesh_4096_2x2"]}),
        ("4096^2 nb128 full", mmaps["4096^2 nb128 full"], *k1k2,
         {"mesh_4096_nccl": c_mesh["mesh_4096_nccl"]}),
        ("4096^2 nb128 full rows x bins", mmaps["4096^2 nb128 full rows x bins"], *k1k2,
         {"mesh_4096_nccl": c_mesh["mesh_4096_nccl"]}),
        ("64 x 32 slab", mmaps["64 x 32 slab"], *k3k4,
         {"demo4": c_mesh["demo4"], "checkpoint_2x2": c_mesh["checkpoint_2x2"]}),
        ("64 x 32 slab rows x bins", mmaps["64 x 32 slab rows x bins"], *k3k4,
         {"checkpoint_2x2": c_mesh["checkpoint_2x2"]}),
        ("64 x 32 full", mmaps["64 x 32 full"], *k3k4,
         {"checkpoint_4x1": c_mesh["checkpoint_4x1"], "checkpoint_nccl": c_mesh["checkpoint_nccl"]}),
        ("64 x 32 full rows x bins", mmaps["64 x 32 full rows x bins"], *k3k4,
         {"checkpoint_4x1": c_mesh["checkpoint_4x1"], "checkpoint_nccl": c_mesh["checkpoint_nccl"]}),
        # phase 44's: the first field rank's slab of 256^3's full-grid map
        # (a field rank of 2 x 2) and the whole map (1 x 1), and their (row,
        # bin) maps; launches a rank
        *[(f"256^3 nb128 {name}", mmaps[f"256^3 nb128 {name}"], *k1k2, runs)
          for name, runs in (
              ("slab", {"tomography_2x2": c_mesh["tomography_2x2_rank0"]}),
              ("slab rows x bins", {"tomography_2x2": c_mesh["tomography_2x2_rank0"]}),
              ("full", {"tomography_nccl": c_mesh["tomography_nccl"]}),
              ("full rows x bins", {"tomography_nccl": c_mesh["tomography_nccl"]}))],
    ]
    icr_paths = {"demo9": (icr["demo9"], {"demo9": c_demo9}),
                 "4100^2": (icr["4100^2"], {"4100^2": c_4100, "icr_4x1": c_mesh["icr_4x1"],
                                            "icr_nccl": c_mesh["icr_nccl"]}),
                 "sphere nside 256": (sphere, {"sphere": c_sphere}),
                 "sphere x radius": (radial, {"sphere_x_radius": c_radial})}
    # phase 43's float32 runs, on maps of phases 5, 6 and 32
    paths32 = [
        ("4096^2 nb128 quarter", cf4096.dist, *k1k2,
         {"float32": c_f32["float32 4096^2 n_bins=128"]}),
        ("128^2 unbinned", cf128.dist, *k3k4, {"float32": c_f32["float32 128^2 unbinned"]}),
        ("64^2 unbinned", demo11_map, *k3k4, {"acceptance": c_f32["acceptance float32"]}),
        # phase 46's legs
        ("256^3 nb128 quarter", cf256.dist, *k1k2,
         {"float32_tomography_256": f32_256["shapes"]["dist"]}),
        ("1024^2 unbinned quarter", cf1024.dist, *k5,
         {"float32_radio_1024": f32_radio["shapes"]["dist"]}),
        ("l map lmax 511", gl_dist, *k1k2, {"float32_demo16": f32_sky["shapes"]["dist"]}),
        ("16^3 unbinned", cf16.dist, *k3k4, {"float32_nuts": f32_nuts["shapes"]["dist"]}),
    ]
    print(json.dumps({"kernels": kernel_entries(kres, paths, src)
                      + kernel_entries(kres, paths32, src, "float32")
                      + icr_kernel_entries(kres_icr, icr_paths)
                      + hp_kernel_entries(kres_hp, {"demo16": k10_demo16}, hp_rings, 512, 256)
                      + los_kernel_entries(kres_los, {
                          "demo1": k11_demo1, "tomography_256": k11_256, "nuts_geovi": k11_geo16,
                          "nuts": k11_nuts,
                          # phase 44: the slabs of the field ranks of 2 x 2 and of 1 x 1
                          **{f"tomography_2x2_rank{r}": c_mesh[f"k11_tomography_2x2_rank{r}"]
                             for r in (0, 1)},
                          "tomography_nccl": c_mesh["k11_tomography_nccl"]})
                      + los_slab_entries(sres_los, {
                          **{f"tomography_2x2_rank{r}": c_mesh[f"slab_tomography_2x2_rank{r}"]
                             for r in (0, 1)},
                          "tomography_nccl": c_mesh["slab_tomography_nccl"]})
                      + k7_kernel_entries(kres_k7, fres_k7, {"radio_1024": k7_radio},
                                          {"cpu_vs_card_32": k7_cpu_vs_card})
                      # phase 46's float32 legs
                      + icr_kernel_entries(kres_icr, {
                          name: (icr[name], {"float32": f32_icr[leg]["shapes"]["icr"]})
                          for name, leg in (("4100^2", "4100^2 deformed chart"),
                                            ("sphere x radius", "sphere x radius"))}, "float32")
                      + hp_kernel_entries(kres_hp, {"float32_demo16": f32_sky["shapes"]["hp"]},
                                          hp_rings, 512, 256, "float32")
                      + los_kernel_entries(kres_los, {
                          "float32_tomography_256": f32_256["shapes"]["los"],
                          "float32_nuts": f32_nuts["shapes"]["los"]}, "float32")
                      + k7_kernel_entries(kres_k7, fres_k7,
                                          {"float32_radio_1024": f32_radio["shapes"]["k7"]}, {},
                                          "float32")}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
