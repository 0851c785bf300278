#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (slate_tpu_torch) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card.  Phases, each
printing one JSON line before the next starts (any failure exits non-zero):

1. card:   device name, and the ``nvidia-smi`` name and power limit line;
2. build:  every csrc/*.cu with nvcc into slate_tpu_torch/_build/, one nvcc
           per source, all started together, beside torch.profiler's
           one-time start-up (seconds of each); then ptxas: each
           kernel's registers, spilled bytes and static shared memory from
           the build logs, and the matmul core's dynamic shared memory (a
           spill in tile_gemm, ft_summa_update, matmul or tile_ops fails);
3. kernel: chol_diag_inv against its plain twin at nb = 256, f32 and f64
           (L and L^-1 each at its own scale, L L^T = A and L X = I by
           reconstruction, a non-SPD block NaN from the same column), with
           kernel, twin and library times and the bound; then the blocked
           kernel's edges: n = 72 and 200 (a ragged last 32-wide panel), and a
           bad pivot at 31 and at 32 (each side of a panel boundary): NaN
           masks equal the twin's, the first NaN diagonal at the bad column,
           the upper triangles exact zeros;
4. posv f32 at n = 32768, nrhs = 32 through linalg.posv_array (the
           panel-stepped scan form): info, backward error, 128 kernel
           launches, seconds after one warm-up run, peak memory;
5. posv f64 at n = 32768 (the left-looking form, 8 panels x 16 leaves);
6. small:  the entry() solve (n = 1024) against torch.linalg.solve in f64;
7. non-SPD: one negative pivot gives the expected info in both forms;
8. the mesh kernels against their plain twins at the mesh path's shapes
   (nb = 256, a virtual 2 x 4 grid): chol_panel_tiles and
   chol_trailing_update (f32, f64) and summa_update (f32), with kernel,
   twin and library times, the bound, TFLOP/s and the fraction of the bound
   reached, and the panel's tile solve timed alone; then tile_mma_edges:
   the tile-GEMM core (csrc/tile_mma.cuh) at ragged nb in {1, 7, 33, 100,
   129, 200}, f32 and f64, on views at offset 0 and 1 element (the 16-byte
   and the element copies): the three update modes and the three
   panel-solve launch forms against their twins within gemm_tol, masked NaN
   tiles bitwise untouched, ft_summa_update against its twin and bitwise
   equal across two launches;
9. mesh_posv f32 at n = 32768, nrhs = 32, nb = 256 on a virtual 2 x 4 mesh
   (from_dense -> potrf_dist -> two trsm_dist -> gemm_summa residual):
   info, backward error, the panel and trailing-update launch counts
   derived from the code, seconds after one warm-up run, peak memory;
10. mesh_posv f64 at n = 16384;
11. mesh_gemm f32: a square gemm_summa (GemmC) at n = 16384 against
   torch.matmul, 64 summa_update launches;
12. the LU kernels against their plain twins at the mesh LU's shapes
   (f32 n = 32768, f64 n = 16384): lu_panel_tiles (diagonal block + the
   owning column's (2, 1, mtl) tiles), lu_rowsolve_tiles (the owning row's
   (1, 4, ntl) tiles) and lu_trailing_update (the bucket-0 window with the
   lookahead exclusions), with kernel, twin and library times and the bound;
   the packed L\\U holds L and U each at its own scale and to A by
   reconstruction; the LU entry points at n = 72 and 200 (L\\U, U^-1 and
   unit-L^-1 against their twins, the structural triangles exact zeros) and
   with a zero pivot at 31 and at 32 (U^-1 finite exactly where the twin's
   is, L\\U and unit-L^-1 finite);
13. mesh_gesv_nopiv f32 at n = 32768 and f64 at n = 16384 (uniform[-1, 1)
   + n I): getrf_nopiv_mesh -> two trsm_dist, info, the normwise backward
   error (gate 100 n eps) and the componentwise one (gate 10 sqrt(n) eps,
   the residual in f64), the launches of all three LU kernels derived from
   ``bucket_plan``, split seconds after a warm-up solve at n = 2048, peak
   memory;
14. mesh_gesv_pp (gesv_mesh, partial pivoting) f32 at n = 32768 and f64 at
   n = 16384 (MixedPrecision off) on uniform[-1, 1): getrf_mesh ->
   permute_rows_dist -> two trsm_dist, nt lu_rowsolve_tiles launches and
   no update kernel (the update is pinned to the matmul form);
15. mesh_gesv_tntpiv f32 at n = 8192 (the tournament is many small torch
   ops per step, so this size keeps the script well inside its limit);
16. the QR kernels against their plain twins (utils.testing.qr_panel_check:
   R's pivots, R's other entries, V below its pivots, tau and T's
   off-diagonal each within 2 m eps of its own largest entry, Q R = A in
   f64, the compact-WY identity; each part zeroed must fail its reading):
   qr_panel at the gels leaf (32768, 64) f32 / (16384, 64) f64 and the mesh
   merge (512, 256), qr_panel_offset on a batch with row0 at 0, a middle
   and the last tile and a zero column, and timed on the mesh path's batch
   of p panels, with library (torch.geqrf, which gives VR and tau but no T),
   the bound and the barrier floor (w times one empty panel barrier at the
   launch's grid); then both kernels at the edge shapes of
   utils.testing.qr_edge_plain / QR_EDGE_OFFSET (kernel_qr_edges);
17. gels: gels_array (MethodGels.QR, 32 right-hand sides) f32 at
   m = 32768, n = 16384 and f64 at m = 16384, n = 8192: the
   normal-equations gate of tester.py's run_gels and the componentwise one
   (omega < 20 eps / sqrt(m), in f64), one qr_panel launch per leaf of
   _geqrf_rec (derived from its split), seconds, peak memory; geqrf's
   Q R = A at n = 4096, and a gels there with TF32 products that omega must
   refuse;
18. mesh_gels: gels_mesh on a virtual 2 x 4 mesh, nb = 256, at the gels
   sizes: nt qr_panel_offset and nt (p - 1) merge qr_panel launches, the
   same gates, agreement with the single-chip X; then its steps
   (from_dense -> geqrf_dist -> unmqr_dist -> the R round trip ->
   trsm_dist) inlined and timed one by one, their X bitwise gels_mesh's;
   and a zero column j giving info j + 1;
19. the FT kernel against its twin (utils.testing.ft_summa_check: acc to
   the tile-update limit, each weighted part to it scaled by sum |w|; a
   zeroed part and an f32 TF32 product must fail): ft_summa_update at one
   step of the f32 n = 16384 gemm_ft ((2, 4, 34, 17) tiles of 256,
   stride-0 panels, the augmented grid's weights) and the f64 n = 8192 one,
   with kernel, twin and library times and the bound;
20. mesh_gemm_ft f32 at n = 16384 and f64 at n = 8192 (virtual 2 x 4): a
   clean Detect run against gemm_mesh (clean report, online discrepancy
   and its threshold, kt ft_summa_update launches, seconds, overhead), FT
   off bitwise gemm_mesh, a seeded trailing fault (corrected) and a seeded
   bcast fault (corrected or recomputed, naming the injected tile), each
   within the plain gemm's gate — in f32 a seeded fault below slate_tpu's
   threshold (16 max|C| at this size) is checked by floor_ratio instead,
   and a flip of 10 thresholds must be corrected;
21. mesh_potrf_ft / mesh_getrf_nopiv_ft f32 and f64 at n = 16384: a clean
   run, a seeded panel-store fault and a panel flip of 10 thresholds (a
   detected one corrected, info 0, the factor within the verify's
   threshold of the clean one, L L^T = A resp. L U = A in f64 within
   n eps n max|L| max|L^T|; one below slate_tpu's threshold checked by
   floor_ratio; the f64 flip must be detected), the launches derived from
   the loop; an f64 potrf trailing fault recomputed;
22. ft_drivers: posv_mesh and gesv_nopiv_mesh f32 at n = 16384 under
   FaultTolerance correct (eta, omega, info 0), and a persistent double
   fault raising FtError;
23. ft_smoke: slate_tpu_torch.ft.smoke on the card (seven scenarios, then
   its RunReport: valid, the ft section, --check against itself passing);
24. mesh_invariants at n = 4096: bitwise across lookahead 0/1/2 and across
   the psum/ring/doubling lowerings, and the non-SPD info rule;
25. lu_invariants at n = 4096: the no-pivot and partial-pivot solves
   bitwise across lookahead 0/1/2 and psum/ring/doubling, and a zero
   column j giving info j + 1;
26. kernel_tile: transpose_tiles, geadd_tiles and genorm_max_tiles against
   their twins, f32 and bf16, at the (16384, 256, 256) tile stack of an
   n = 32768 matrix and a small mb != nb stack with a NaN tile (transpose
   and genorm_max bitwise, NaN included; geadd within eps (|alpha a| +
   |beta b|)), with kernel, twin and library times, the bound and a copy
   of the stack as the card's copy rate; then the stacks that reach every
   path of csrc/tile_ops.cu (TILE_EDGES: an aligned ragged stack, a
   misaligned a[1:] view, a whole-vector stack one word off, k > 65535 of
   two- and eight-row tiles; TILE_SPECIAL: NaN in a vector's last lane and
   a peeled head and tail, +-inf, -0.0, subnormals), each one launch a
   kernel, bitwise, printing the path the host rule names and the one the
   source picks (they must agree); then kernel_tile_max_split: the max's
   two splits (a CTA a tile, a warp a tile) both timed on 256 MiB stacks
   of 512 B to 128 KB tiles, on a 12-tile stack and on the full stack,
   each bitwise the twin, beside the split the host rule picks;
27. tile_transpose: slate_tpu_torch.ops.transpose on that stack, f32 and
   bf16: one transpose_tiles launch each, bitwise the swapped axes; a k = 4
   stack (below the gate) launches nothing;
28. gesv: gesv_array with 32 right-hand sides on uniform[-1, 1), f32 at
   n = 32768 (the recursive form), f64 at n = 16384 (on the card, the
   scanned form) and at n = 8192 (the left-looking form), each after a
   warm-up at n = 2048: info, eta, omega (f64 residual), the form taken,
   seconds, peak memory;
29. gesv_methods: MethodLU.NoPiv and CALU, f32 at n = 8192, the same gates;
30. mixed: gesv_mixed_array and posv_mixed_array f64 at n = 16384 against
   the full f64 solves of the same matrices, and gesv_mixed_gmres_array at
   n = 4096 (uniform[-1, 1) + n I, residual norm under GMRES's tolerance):
   iterations, converged, eta and the refinement's own gate;
31. lu_misc: getri_array f64 at n = 4096, gecondest against the exact
   1 / kappa_1 of a 256 x 256 matrix, and a zero column giving info j + 1
   in the f32 and f64 forms;
32. kernel_matmul: matmul_pallas (csrc/matmul.cu: TMA + wgmma, f32 as six
   bf16 plane products) against its twin (utils.testing.matmul_pallas_excess:
   9 sqrt(k) eps32 |A||B| elementwise, Higham and Mary's probabilistic
   bound, plus one output ulp in bf16/f16) at f32, bf16 and f16 8192^3, the
   thin-k rank update (32768 x 256)(256 x 32768) in f32 and bf16 and a
   ragged 1000 x 777 x 1234, one launch per call of ops.matmul_pallas and a
   second call bitwise the first, with kernel, twin and library
   (torch.matmul, TF32 off) times, each operand's path (in place or packed)
   and the pack's share of the time, peak memory over the call, and the
   bound (the tensor cores' 989 TFLOP/s; f32 six such passes, the FFMA
   bound at 67 beside it); at each shape the kernel's C with 8 k indices
   dropped must read above the limit, and at 8192^3 the kernel's error from
   the f64 product must stay within 2 k / (bk + k / bk) times the twin's (a
   TF32 product's, which passes the elementwise limit, is read beside it);
33. ozaki: ops.ozaki.matmul_f64 / matmul_c128 at 512 bitwise the CPU's
   result; matmul_f64 at 8192 against cuBLAS DGEMM (time, relative error);
   gemm_summa_ozaki at n = 8192 on 2 x 4 against the f64 gemm_summa (times,
   audited bytes exactly 9/8);
34. mixed_mesh: the f64 mesh ladder (2 x 4, nb = 256, 32 rhs), each after a
   warm-up at n = 1024: posv_mesh n = 16384 under auto, auto with the Ozaki
   residual and off; gesv_mesh n = 8192 under auto and off; a cond-1e12
   gesv at n = 2048 that escalates (ir.escalated_gmres and ir.fallback +1);
   posv_mesh under FaultTolerance at n = 8192: seconds, peak memory, tier,
   iters, ir.* deltas, launches, eta, omega and the refinement gate;
   then ladder_kernels: summa_update in f64 (the residual SUMMA) and, in
   f32, chol_panel_tiles, chol_trailing_update and lu_rowsolve_tiles held
   against their twins at the inputs of their widest call in the measured
   posv (n = 16384) and gesv (n = 8192) auto runs, summa_update's f64 row
   taking the posv run's launches;
35. mixed_smoke: slate_tpu_torch.parallel.mixed_smoke on the card (with
   its RunReport: valid, the ir section, --check against itself passing);
36. mesh_blas3 f32 at n = 16384 and f64 at n = 8192 (2 x 4, nb = 256):
   hemm_summa Left under HemmC (B n x n) and HemmA (B n x 1024, the rule's
   pick), hemm_summa Right, her2k_dist full, trmm_dist Left lower,
   herk_dist and trsm_dist_right: seconds after a warm-up, peak memory,
   the error against an f64 product on the card within gemm_tol plus
   2 sqrt(k) eps |C| per entry, lookahead 0 bitwise lookahead 1;
37. mesh_inverse: potri_mesh (f32 16384 / f64 8192) and getri_mesh (f32
   8192 / f64 4096): info, max|A X - I| / (n eps max|A| max|X|) < 100, the
   launches of chol_panel_tiles, chol_trailing_update and
   lu_rowsolve_tiles derived from the loops, then pocondest_dist /
   gecondest_dist on the drivers' factors against 1 / kappa_1 of the
   computed inverse;
38. ft_her2k: her2k_mesh under FaultTolerance, f64 n = 8192 (clean
   overhead, a seeded trailing fault corrected to 1e-12 max|C|) and f32
   n = 16384 (its action and floor ratio);
39. eig_mesh: heev_mesh (2 x 4, nb = 64, vectors, the distributed
   solver) f32 at n = 6144 (cut from 8192 to make room for the obs phase)
   and f64 at n = 2048 (cut from 4096: the chase is a host-bound eager
   loop) on (G + G^T) / 2, after a
   warm-up at n = 256: seconds, the split (he2hb_dist, gather_diagband +
   hb2st, stedc_dist, chase_apply_dist, unmtr_he2hb_dist), peak memory,
   _he2hb_panel_count qr_panel_offset launches; gates: max|A Z - Z W| /
   (max|A| n) and max|Z^T Z - I| < 100 n eps, w within n eps ||A||_2 of
   torch.linalg.eigvalsh in f64;
40. svd_mesh: svd_mesh (2 x 4, nb = 64) f32 6144^2 (cut from 8192 to make
   room for the obs phase) and f64 2048^2 (cut as eig_mesh's) on a
   Gaussian A: the same readings (the split: ge2tb_dist, gather_diagband +
   tb2bd, bdsqr, the two chase_apply_dist, unmbr_ge2tb_u_dist /
   _v_dist), nblocks + LQ-panel qr_panel_offset launches; gates:
   max|A - U S Vh| / (max|A| n), max|U^T U - I|, max|Vh Vh^T - I|
   < 100 n eps, s within n eps s_max of torch.linalg.svdvals in f64
   (gesvd for an f64 A);
41. kernel_qr_he2hb: qr_panel_offset against its twin on the first and
   last he2hb panel the f32 / f64 eig_mesh run gave it ((n, 64), row0 = 64
   and n - 64; utils.testing.qr_panel_check, the mutants, rows above row0
   untouched), timed with its twin, torch.geqrf and the bound;
42. eig_single: heev_array and svd_array f32 at n = 2048, nb = 32: the
   same readings and launches;
43. band_single: pbsv_array (kd = 128, the windowed factor at nb = 64)
   f32 at n = 32768 and f64 at n = 16384, gbsv_array (kl = ku = 64, the
   windowed pivoted factor at nb = 32) f32 at n = 16384 and f64 at 8192,
   each after a warm-up at n = 1024: info, eta (and omega for gbsv),
   seconds, peak memory, no hand-kernel launch; the pb factor against the
   library's dense f64 Cholesky of the same band and the gb factor by P A
   = L U rebuilt from its window-local permutations (ratios to n eps
   max|A|); the band time beside the dense solve's (posv f32 32768 from
   phase 4; gesv_array once on the f64 gb operand);
44. band_wide: pbsv_array f32 at n = 20480, kd = 8192 (4 kd > n: the dense
   route, the scan form of potrf_array): info, eta, seconds, and exactly
   n / 256 = 80 chol_diag_inv launches, which join row 5's f32 launches;
45. band_mesh (2 x 4, nb = 256): pbsv_mesh f32 n = 32768 / f64 16384 at
   kd = 512, gbsv_mesh f32 8192 / f64 4096 at kl = ku = 256, tbsm_mesh
   f32 8192 (kd = 256) with and without a row permutation, each after a
   warm-up at n = 1024: info, eta (omega for gbsv), seconds and the split
   (factor, permute, trsm_dist, from_dense, to_dense), peak memory, no
   hand-kernel launch, and pbtrf_band_dist at lookahead 0 and 1 bitwise;
46. hesv_single: hesv_array (nb = 32, 32 right-hand sides) on a Hermitian
   indefinite uniform[-1, 1) operand, f32 n = 1536, f64 1024, complex64
   512, each after a warm-up at n = 256: info 0, eta < 100 n eps, seconds
   split into he2hb, hb2st, the Q^H apply, gtsv and the Q apply, peak
   memory, qr_panel_offset launches derived from _he2hb_panel_count (0 for
   complex, whose panels keep the library pair); then gtsv_array alone,
   f64 n = 2048 with a small diagonal: the share of steps that swapped,
   the error against torch.linalg.solve in f64 (ratio to n eps max|x|),
   microseconds a step;
47. gesv_rbt: gesv_rbt_array on uniform[-1, 1), 32 right-hand sides, f32
   n = 8192 and f64 n = 8191 (the identity-pad path): info 0, eta <
   100 n eps, omega beside 10 sqrt(n) eps (a reading), no hand-kernel
   launch, RBTFactors.solve on a fresh right-hand side under the eta gate,
   gesv_array NoPiv on the same operand beside it (readings); f64 n = 1024
   with A[0, 0] = 0: NoPiv reports a nonzero info or a non-finite X, RBT
   passes;
48. redistribute_mesh: f32 n = 16384, nb = 256, off the virtual 2 x 4
   mesh: to 4 x 2 under eager and shardmap (the ring), bitwise equal, the
   ring's audited bytes redistribute_wire_bytes, the moved bytes' rate
   against 3.35 TB/s; to 1 x 8 with diag_pad at n = 15260 (60 tiles grow
   to 64; the fresh pad tiles the identity under both lowerings); nb 256
   -> 512 -> 256 bitwise; then the non-uniform tiling at f32 n = 8192
   (tile sizes cycling 256, 128, 192): the round trip bitwise, gemm_summa
   within product_ratio of the f64 product (kt summa_update launches), and
   redistribute_nonuniform -> potrf_dist -> two trsm_dist: info 0, eta <
   100 n eps, chol_panel_tiles / chol_trailing_update launches derived by
   expected_potrf_launches; then slice7b_seconds: the three phases' own
   seconds and their sum beside the 30 s budget;
49. ckpt_mesh (2 x 4, nb = 256, after a warm-up chain at n = 1024):
   potrf_ckpt f32 n = 16384 every 16 steps, getrf_nopiv_ckpt f32 16384
   (uniform[-1, 1) + n I) every 16, getrf_pp_ckpt f32 1024 every 3,
   geqrf_ckpt f32 8192 x 4096 every 4 and he2hb_ckpt f32 4096 every 4:
   the chain bitwise the plain driver, its launches derived by
   expected_ckpt_launches (every step in the strict schedule) and its
   snapshot count; a seeded kill in the second segment (the lost steps
   exact) and the same-mesh resume bitwise, the kill + resume launches
   the chain's; for the three tile-stack ops the 2 x 4 -> 4 x 2 resume
   bitwise (pp's perm too), the ring's audited bytes
   redistribute_wire_bytes, info 0 and eta < 100 n eps through the two
   trsm_dist sweeps; for geqrf / he2hb the refusal of the 4 x 2 grid;
   potrf's in-segment kill (lost steps kill.k - 16, launches the chain's
   plus the re-run steps') and async snapshots (the chain bitwise, the
   killed run's snapshot bitwise the sync one); pp's disk round trip;
   plain and chain seconds (the overhead), resume seconds and peak
   memory, and one sync and one async snapshot timed alone (seconds and
   GB/s to the host, bitwise each other); then slice9b_seconds: each
   op's seconds and their sum beside the 15 s budget, with the card line;
   then ft.ckpt_smoke on the card, its RunReport valid and --check of it
   against itself passing;
50. obs (2 x 4, nb = 256, after a warm-up at n = 2048): posv_mesh f32 at
   n = 32768 and its gemm_summa residual with obs off, then on: X and R
   bitwise, the span tree (posv_mesh over potrf_mesh > potrf_dist and two
   trsm_dist, gemm_summa beside it), each span's comm bytes equal to a
   comm audit of the same call, seconds on and off, eta, the launches of
   the obs-on run (and, equal, the obs-off run's) derived by
   expected_potrf_launches; then obs.flight.run_flight for
   potrf f32 n = 32768, summa, getrf_nopiv and trsm at 8192, geqrf
   8192 x 4096 and he2hb 4096 (lookahead 1; the strict chains 0): each
   flown result bitwise its plain driver, the rows and the launches of the
   whole flight (plain, flown and the depth-0 contrast) derived from the
   loops, overlap_eff 0 at depth
   0 and in (0, 1] at depth 1 (0 for the strict chains), the model's bytes
   equal to the measured ones and to a comm audit of the runs, the
   FlightReport valid, the residual over 64 sampled columns under 100 n
   eps, the potrf Gantt valid; one instrumented potrf_dist under
   torch.profiler's host activity (its span in the profile), obs.smoke on
   the card; then
   slice10a_seconds: the phase's seconds by part beside the 20 s budget,
   with the card line.  On one card a bcast row is indexing: its seconds
   are fence and host overhead, not wire time;
51. obs_num_mem (2 x 4, nb = 256): Option.NumMonitor and the memory
   layer.  posv_mesh f32 16384 off, on and off again: X bitwise, the
   audited bytes equal, the monitored launches derived by
   expected_potrf_launches, the margin finite and > 0, seconds on and off;
   getrf_nopiv_mesh f32 8192 on at lookahead 0 and 1, the gauges bitwise
   each other and the factor bitwise the off run's, and three off / on
   pairs at lookahead 1 timed; potrf_dist 16384 alone off, on, off (the
   posv's difference less the exit read's); gels_mesh 8192 x 4096
   and he2hb_dist 4096 in f64 monitored, the orthogonality gauges under
   ORTH_THRESHOLD (an f64 bound); the Wilkinson matrix (n = 64, nb = 8)
   through getrf_mesh, growth exactly 2^63, and through the monitored
   getrf_nopiv_ckpt every 2, its GrowthAbort at the boundary the gauge
   predicts (wilkinson_abort_step); a monitored potrf_ckpt f32 4096 killed
   at step 8 and resumed, its gauges bitwise the unbroken chain's; the f64
   gesv_mesh at n = 1024, cond 1e8, two GMRES restarts: routed to GMRES
   (num.routed_gmres 1, no IR solve), omega under the ladder's gate
   (GESV_LADDER_OMEGA 10 sqrt(n) eps); memwatch potrf f32 16384 on the
   card, the MemoryModel within 10% of the traced temp, the allocator's
   peak beside the traced out + temp, the traced tally at n = 64 the same
   on the host and the card, a memory-sampled potrf flight's Gantt with
   its memory counter tracks valid; the RunReport's mem and num sections
   valid and non-empty; one OOM (potrf_dist on a stack of 0.6 of the card,
   whose copy the model puts past it): torch.cuda.OutOfMemoryError with
   exactly one forensics report; then slice10b_seconds: the phase's
   seconds by part beside the 10 s budget, with the card line;
52. serve (slice 11a, the serving core; bins 256-4096): posv_batched f64
   at bin 4096 and f32 / f64 at 512, B = 8, each row bitwise posv_array of
   its problem, info 0, eta < 100 n eps, solves/s, the 4096 stack's
   chol_diag_inv launches derived by potrf_ll_leaves (16 a problem);
   serve.smoke.measure_throughput at n = 512, B = 8 beside the posv_mesh
   loop (the ratio and its >= 3x gate); posv_packed_mesh of k = 4 ragged
   f64 problems (n = 900-1024, bin 1024: one 4096 operand on 2 x 4,
   nb = 256, MixedPrecision off), each solution bitwise the problem packed
   alone, the launches by expected_potrf_launches, and the same at bin 200
   (every tile straddles two problems); a meshless Router stream of 32
   ragged f64 posv / gesv requests over bins 256-1024 (gesv up to 512; one
   operand at cond 1e9: the hostile GMRES-IR tier), obs on, run twice: one build per cache
   key and none in the second pass (assert_steady), every request one
   "served" outcome, the request timeline valid, p50 <= p95 <= p99 per
   class, each answer under its gate and the second pass bitwise the
   first; the resilient mesh router at f64 n = 2048 (2 x 4, nb = 256):
   posv under Checkpoint every 4 killed at step 6 (one serve.resumes, the
   answer bitwise the unbroken chain's, the launches by
   expected_ckpt_launches), a kill at step 1 (reject_unresumable), gesv
   under FaultTolerance Detect with one panel flip (one serve.retries,
   twice expected_ft_launches); Router.gels f64 4096 x 2048 with
   NumMonitor on (tester.py's residual gate, omega, no orth retry, nt
   qr_panel_offset and nt (p - 1) qr_panel launches); serve.tune's
   time_gemm_method at f64 2048 (GemmA against GemmC: kt summa_update a
   GemmC run); then slice11a_seconds beside its 10 s budget, with the card
   line;
53. serve_queue (slice 11b, the service layer): a Service (BatchQueue on
   the wall clock, B = 8, T = 5 ms, its worker and ServiceController) over
   a meshless Router on the card, two tenants weighted 2:1, and 8 client
   threads calling Service.solve with 64 posv f64 requests ragged in
   3000-4096 (all at bin 4096) and 4 gesv f64 at bin 512, obs on:
   requests/s, windows by cause (full / expired), p50 / p95 / p99 from
   serve.trace.sla_values, the controller's actuations; then the same 68
   requests one at a time through Router.solve on a fresh Router (its
   requests/s and the ratio); every concurrent answer bitwise that solve,
   every trace "served", serve.queue_pump_errors 0, no failed ticket, the
   chol_diag_inv launches derived by potrf_ll_leaves (16 a posv); the
   packed dispatch through a mesh Router (2 x 4, nb = 256, f64, bins
   (1024,)): one window of 1024, 1000, 950, 900 as one block-diagonal
   program, each solution bitwise the problem packed alone, the launches by
   expected_potrf_launches; the HTTP front door (start_http on
   127.0.0.1:0): 4 client threads POST 16 /solve at n = 64 (each 200 and
   bitwise Router.solve), a malformed body 400, a budget refusal 429, no
   5xx, /queue.json, /healthz and /metrics (validate_prometheus_text);
   serve.queue_smoke.run_smoke and obs.live.run_ci on the card into
   chiprun_out/ (each exit 0); then slice11b_seconds beside its 10 s
   budget, with the card line;
54. dryrun: the port's dryrun (posv_chain, gesv_pp, hemm_summa,
   stedc_dist, heev_chain, the LU panel_pallas half, flight_timeline, mem;
   n = 64, nb = 8, 2 x 4);
55. total: the script's seconds; then kernels: the line of every ported
   kernel (one row per kernel and dtype, all 14 TPU kernels; geadd_tiles
   and genorm_max_tiles, which no driver reaches, count the launches of
   their timed calls in phase 26, and matmul_pallas's f32, bf16 and f16
   rows those of phase 32's public 8192^3 calls; the chol_panel_tiles,
   chol_trailing_update and lu_rowsolve_tiles rows also carry
   ``launches_by_path``, their mesh posv / nopiv launches beside those of
   phase 37's potri_mesh / getri_mesh and, in f32, phase 48's non-uniform
   posv (summa_update's f32 row its non-uniform gemm), chol_diag_inv's f32
   row its posv and phase 44 launches, and the qr_panel_offset rows
   those of phases 39, 40, 42 and 46 beside the mesh gels' and, under
   ``at_he2hb_panel``, phase 41's readings; the f32 rows of the kernels
   phase 49 reaches add its chains' launches under ``<op>_ckpt``, and
   those phase 50 reaches its flights' under ``flight_<op>`` (every driver
   run of the flight) and the obs-on posv's under ``obs_posv``; the rows
   phase 51's paths reach, at their dtype, those paths' launches under
   ``num_<op>`` and ``mem_<op>``, those phase 52's reach under
   ``serve_<path>`` and those phase 53's under ``serve_queue_<path>``),
   then the card line and, last,
   {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""

import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, contextmanager

NB = 256
N_MAIN = 32768
NRHS = 32
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit):
# HBM 3.35 TB/s; 67 TFLOP/s f32 outside the tensor cores, 67 TFLOP/s f64 on
# the FP64 tensor cores (DMMA, IEEE double)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"float32": 67e12, "float64": 67e12}
# the tile kernels compute bf16 stacks in f32 on the CUDA cores
PEAK_FLOPS_S["bfloat16"] = PEAK_FLOPS_S["float32"]
# the mesh path: a virtual 2 x 4 grid; f64 runs at half the f32 size
P, Q = 2, 4
MESH_N = {"float32": 32768, "float64": 16384}
GEMM_N = 16384
INVARIANT_N = 4096


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def ptxas_report(log):
    """{kernel: {"registers", "spill_bytes", "smem_bytes"}} (static shared
    memory) from the build log of
    ``nvcc -Xptxas -v`` (slate_tpu_torch/ops/_build.py keeps it beside the
    library); names demangled where c++filt is found."""
    with open(log) as f:
        text = f.read()
    out, cur, spill = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur] = {"registers": int(m.group(1)), "spill_bytes": spill,
                        "smem_bytes": int(smem.group(1)) if smem else 0}
            cur = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except OSError:
        names = []
    if len(names) != len(out):
        return out
    short = [n.replace("(anonymous namespace)::", "").split("(")[0] for n in names]
    return dict(zip(short, out.values()))


def cuda_ms(fn, reps, torch):
    """Mean milliseconds of fn() over reps calls, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spd_block(nb, dtype, seed, torch):
    g = torch.randn((nb, nb), generator=torch.Generator(device="cuda").manual_seed(seed),
                    dtype=torch.float64, device="cuda")
    return (g @ g.T / nb + torch.eye(nb, dtype=torch.float64, device="cuda")).to(dtype)


def dominant_spd(n, dtype, seed, torch):
    """Symmetric uniform[-1, 1) + n I: diagonally dominant, hence SPD, made
    on the device with no n^3 product."""
    u = torch.rand((n, n), generator=torch.Generator(device="cuda").manual_seed(seed),
                   dtype=dtype, device="cuda")
    u.mul_(2).sub_(1)
    a = u.tril()
    a.add_(u.tril(-1).T)
    del u
    a.diagonal().add_(n)
    return a


def eta(a, x, b, torch):
    """Normwise backward error max|AX-B| / (max|A| max|X| n + max|B|)."""
    r = (torch.matmul(a, x) - b).abs().max()
    return float(r / (a.abs().max() * x.abs().max() * a.shape[0] + b.abs().max()))


def kernel_phase(dtype, kernels, torch):
    name = str(dtype).replace("torch.", "")
    eps = torch.finfo(dtype).eps
    a = spd_block(NB, dtype, SEED + 1, torch)
    l, x = kernels.chol_diag_inv(a)
    torch.cuda.synchronize()
    lp, xp = kernels.chol_diag_inv_plain(a)
    # L and L^-1 each at its own scale, L L^T = A and L X = I by
    # reconstruction (chol_factor_check)
    fac = chol_factor_check(a, l, lp, x, xp, eps, torch)
    err_l, err_x = fac["err_L"], fac["err_Linv"]
    check(torch.isfinite(l).all() and torch.isfinite(x).all(), f"{name}: non-finite kernel output")
    check(chol_factor_ok(fac), f"{name}: kernel vs twin {fac}")
    # non-SPD: NaN from the same column in kernel and twin
    bad = a.clone()
    j = 100
    bad[j, j] = -1.0
    lb, xb = kernels.chol_diag_inv(bad)
    lbp, xbp = kernels.chol_diag_inv_plain(bad)
    nan_k = torch.isnan(lb.diagonal()).nonzero()
    nan_p = torch.isnan(lbp.diagonal()).nonzero()
    first_k = int(nan_k[0]) if len(nan_k) else -1
    first_p = int(nan_p[0]) if len(nan_p) else -1
    check(first_k == first_p == j, f"{name}: first NaN column kernel {first_k}, twin {first_p}, expected {j}")
    check(torch.equal(torch.isnan(lb), torch.isnan(lbp)) and torch.equal(torch.isnan(xb), torch.isnan(xbp)),
          f"{name}: NaN patterns of kernel and twin differ")
    edges = chol_edges(dtype, kernels, torch)
    ms = cuda_ms(lambda: kernels.chol_diag_inv(a), 200, torch)
    plain_ms = cuda_ms(lambda: kernels.chol_diag_inv_plain(a), 3, torch)

    def library():
        lo, _ = torch.linalg.cholesky_ex(a)
        torch.linalg.solve_triangular(lo, eye, upper=False)

    eye = torch.eye(NB, dtype=dtype, device="cuda")
    library_ms = cuda_ms(library, 200, torch)
    # the lower triangle of A read once (the kernel never reads the upper),
    # dense L and L^-1 written once
    nbytes = (NB * (NB + 1) // 2 + 2 * NB * NB) * a.element_size()
    flops = 2 * NB ** 3 / 3  # factor nb^3/3 + triangular inverse nb^3/3
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS_S[name] * 1e3
    row = {
        "name": f"chol_diag_inv[{name}]", "route": "cuda",
        "source": "slate_tpu_torch/csrc/chol_diag_inv.cu",
        "replaces": "slate_tpu/ops/pallas_ops.py:471",
        "launches": None, "max_abs_err": max(err_l, err_x),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    emit({"phase": f"kernel_{name}", "nb": NB, **fac, "nan_first_col": first_k, "edges": edges,
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]})
    return row


# the blocked kernels' edges: a ragged last 32-wide panel, and a bad pivot on
# each side of a panel boundary
EDGE_N = (72, 200)
EDGE_COLS = (31, 32)


def chol_edges(dtype, kernels, torch):
    """chol_diag_inv against its twin at n = 72 and 200 (chol_factor_check),
    and with a[j, j] = -1 at j = 31 and 32: the NaN masks of L and L^-1
    equal, the first NaN diagonal at j, the upper triangles exact zeros.
    Returns the largest reading of each kind."""
    eps = torch.finfo(dtype).eps
    worst = {"err_ratio": 0.0, "rec_ratio": 0.0, "inv_ratio": 0.0}
    for n in EDGE_N:
        a = spd_block(n, dtype, SEED + 100 + n, torch)
        lk, xk = kernels.chol_diag_inv(a)
        torch.cuda.synchronize()
        lp, xp = kernels.chol_diag_inv_plain(a)
        fac = chol_factor_check(a, lk, lp, xk, xp, eps, torch)
        check(chol_factor_ok(fac), f"chol_diag_inv {dname(dtype)} n={n}: {fac}")
        check(torch.equal(lk.triu(1), torch.zeros_like(lk).triu(1))
              and torch.equal(xk.triu(1), torch.zeros_like(xk).triu(1)),
              f"chol_diag_inv {dname(dtype)} n={n}: upper triangle not exactly zero")
        worst["err_ratio"] = max(worst["err_ratio"], fac["err_L"] / fac["tol_L"],
                                 fac["err_Linv"] / fac["tol_Linv"])
        worst["rec_ratio"] = max(worst["rec_ratio"], fac["rec_ratio"])
        worst["inv_ratio"] = max(worst["inv_ratio"], fac["inv_ratio"])
        for j in EDGE_COLS:
            bad = a.clone()
            bad[j, j] = -1.0
            lb, xb = kernels.chol_diag_inv(bad)
            lbp, xbp = kernels.chol_diag_inv_plain(bad)
            first = torch.isnan(lb.diagonal()).nonzero()
            check(len(first) > 0 and int(first[0]) == j
                  and torch.equal(torch.isnan(lb), torch.isnan(lbp))
                  and torch.equal(torch.isnan(xb), torch.isnan(xbp))
                  and torch.equal(xb.triu(1), torch.zeros_like(xb).triu(1)),
                  f"chol_diag_inv {dname(dtype)} n={n}: NaN pattern of a bad pivot at {j}")
    return worst


def chol_factor_check(a, lk, lp, xk, xp, eps, torch):
    """The kernel's Cholesky factor ``lk`` (and inverse ``xk``, if given) of
    block ``a`` against the twin's ``lp`` (``xp``) and against ``a``: L
    within 100 nb eps of the twin's largest |L| (its own scale, not A's),
    L^-1 likewise at its own scale; L L^T = A and L X = I, the products in
    f64, within 3 nb eps |L||L^T| and 3 nb eps |L||X| elementwise (the
    backward error bound gamma_nb of any summation order, unit roundoff
    eps / 2, plus the check's own product, with room).  A zero or 1e-3-off
    L fails the reconstruction.  Returns the readings and limits."""
    nb = a.shape[-1]
    lmax = float(lp.abs().max())
    l64 = lk.double()
    out = {"err_L": float((lk - lp).abs().max()), "tol_L": 100 * nb * eps * lmax, "max_abs_L": lmax,
           "rec_ratio": residual_ratio(l64, l64.T, a.double(), nb, eps, torch),
           "rec_rel_limit": 3 * nb * eps}
    if xk is not None:
        xmax = float(xp.abs().max())
        eye = torch.eye(nb, dtype=torch.float64, device=a.device)
        out.update({"err_Linv": float((xk - xp).abs().max()), "tol_Linv": 100 * nb * eps * xmax,
                    "max_abs_Linv": xmax,
                    "inv_ratio": residual_ratio(l64, xk.double(), eye, nb, eps, torch)})
    return out


def chol_factor_ok(c):
    """Each limit below 1e-2 of what it holds, each reading within it."""
    ok = (c["tol_L"] < 1e-2 * c["max_abs_L"] and c["rec_rel_limit"] < 1e-2
          and c["err_L"] < c["tol_L"] and c["rec_ratio"] <= 1)
    if "err_Linv" in c:
        ok = ok and c["tol_Linv"] < 1e-2 * c["max_abs_Linv"] and c["err_Linv"] < c["tol_Linv"] \
            and c["inv_ratio"] <= 1
    return ok


def residual_ratio(lhs64, rhs64, want64, nb, eps, torch):
    """max |lhs rhs - want| / (3 nb eps |lhs||rhs|), in f64; 0/0 reads 0."""
    res = (lhs64 @ rhs64 - want64).abs()
    bound = 3 * nb * eps * (lhs64.abs() @ rhs64.abs())
    return float(torch.nan_to_num(res / bound, nan=0.0, posinf=float("inf")).max())


def posv_phase(dtype, kernels, posv_array, torch):
    name = str(dtype).replace("torch.", "")
    n = N_MAIN
    a = dominant_spd(n, dtype, SEED + 2, torch)
    b = torch.randn((n, NRHS), generator=torch.Generator(device="cuda").manual_seed(SEED + 3),
                    dtype=dtype, device="cuda")
    x, f, info = posv_array(a, b)  # warm-up: cuBLAS/cuSOLVER handles, allocator
    del x, f, info
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.chol_diag_inv.launches = 0
    t0 = time.perf_counter()
    x, f, info = posv_array(a, b)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.chol_diag_inv.launches
    peak = torch.cuda.max_memory_allocated()
    del f
    e = eta(a, x, b, torch)
    gate = 100 * n * torch.finfo(dtype).eps
    emit({"phase": f"posv_{name}", "n": n, "nrhs": NRHS, "info": int(info), "eta": e,
          "eta_gate": gate, "kernel_launches": launches, "seconds": seconds,
          "peak_mem_bytes": peak, "x_finite": bool(torch.isfinite(x).all())})
    check(int(info) == 0, f"posv {name}: info {int(info)}")
    check(e < gate, f"posv {name}: eta {e} >= {gate}")
    check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()), f"posv {name}: bad solution")
    check(launches == n // NB, f"posv {name}: {launches} kernel launches, expected {n // NB}")
    del a, b, x
    torch.cuda.empty_cache()
    return launches, seconds


def small_phase(torch):
    from slate_tpu_torch.entry import entry

    fn, (a, b) = entry(device="cuda")
    x, info = fn(a, b)
    ref = torch.linalg.solve(a.double(), b.double())
    rel = float((x.double() - ref).abs().max() / ref.abs().max())
    e = eta(a.double(), x.double(), b.double(), torch)
    emit({"phase": "small_entry", "n": a.shape[0], "info": int(info), "rel_err_vs_f64_solve": rel, "eta": e})
    # f32 solve of a well-conditioned (cond ~ 4) system against an f64 solve
    check(int(info) == 0 and rel < 1e-4, f"entry posv: info {int(info)}, rel err {rel}")


def non_spd_phase(kernels, potrf_array, torch):
    # f32 scan form at the main size: the breakdown sits in the last panel
    # step of its bucket (steps 32..63 of 128), where the info code is
    # 1 + the first bad pivot; earlier in a bucket slate_tpu's masked
    # full-width update NaN-poisons the bucket's earlier diagonals too, and
    # the port reproduces that (tests/test_torch_chol.py)
    # f64 left-looking form at n = 8192 (nb = 2048): info is 1 + the bad pivot
    out = {"phase": "non_spd"}
    for dtype, n, j in ((torch.float32, N_MAIN, 63 * NB + 50), (torch.float64, 8192, 5000)):
        a = dominant_spd(n, dtype, SEED + 4, torch)
        a[j, j] = -1.0
        _, info = potrf_array(a)
        name = str(dtype).replace("torch.", "")
        out[f"{name}_n"], out[f"{name}_info"], out[f"{name}_expected"] = n, int(info), j + 1
        del a
        torch.cuda.empty_cache()
    emit(out)
    for name in ("float32", "float64"):
        check(out[f"{name}_info"] == out[f"{name}_expected"],
              f"non-SPD {name}: info {out[f'{name}_info']}, expected {out[f'{name}_expected']}")


# ---------------------------------------------------------------------------
# the mesh slice: virtual 2 x 4 grid on the card
# ---------------------------------------------------------------------------


def dname(dtype):
    return str(dtype).replace("torch.", "")


def row_of(name, dtype, source, replaces, err, ms, plain_ms, library_ms, nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dname(dtype)] * 1e3
    return {"name": f"{name}[{dname(dtype)}]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def randn(shape, dtype, seed, torch, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype, device="cuda") * scale


def mesh_tiles(n, dtype, seed, torch, local_view):
    """A random cyclic tile stack of an n x n matrix and its local view
    (p, q, mtl, ntl, nb, nb): the strides the mesh drivers hand the kernels."""
    t = randn((n // NB, n // NB, NB, NB), dtype, seed, torch)
    return t, local_view(t, P, Q)


def kernel_panel_phase(dtype, kernels, local_view, torch):
    """chol_panel_tiles at the f32/f64 mesh path's widest panel: the owning
    column's p x mtl tiles of a bucket-0 view, strided."""
    name = dname(dtype)
    eps = torch.finfo(dtype).eps
    n = MESH_N[name]
    t, loc = mesh_tiles(n, dtype, SEED + 11, torch, local_view)
    pcol = loc[:, 1:2, :, 1]  # (p, 1, mtl, nb, nb), as panel(k) slices it
    dtile = spd_block(NB, dtype, SEED + 12, torch)
    fac, err_s, tol_s, smax = hold_chol_panel(name, dtile, pcol, kernels, torch)
    err_l = fac["err_L"]
    ms = cuda_ms(lambda: kernels.chol_panel_tiles(dtile, pcol), 20, torch)
    plain_ms = cuda_ms(lambda: kernels.chol_panel_tiles_plain(dtile, pcol), 2, torch)

    def library():
        lo, _ = torch.linalg.cholesky_ex(dtile)
        torch.linalg.solve_triangular(lo.T, pcol, upper=True, left=False)

    library_ms = cuda_ms(library, 20, torch)
    ntiles = pcol.shape[0] * pcol.shape[2]
    isz = dtile.element_size()
    nbytes = (NB * (NB + 1) // 2 + NB * NB + 2 * ntiles * NB * NB) * isz
    # factor nb^3/3 + triangular inverse nb^3/3, then one product with the
    # triangular L^-T per tile, nb^3
    flops = 2 * NB ** 3 / 3 + NB ** 3 * ntiles
    row = row_of("chol_panel_tiles", dtype, "slate_tpu_torch/csrc/tile_gemm.cu",
                 "slate_tpu/ops/pallas_ops.py:491", max(err_l, err_s), ms, plain_ms, library_ms,
                 nbytes, flops)
    tile_ms = tile_half_ms(kernels, pcol, kernels.chol_diag_inv(dtile)[1], True, False, torch)
    emit({"phase": f"kernel_chol_panel_tiles_{name}", "tiles": list(pcol.shape), **fac,
          "err_solved": err_s, "tol_solved": tol_s, "max_abs_solved": smax,
          "kernel_ms": ms, "tile_ms": tile_ms,
          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": row["bound_ms"],
          "bound_by": row["bound_by"]})
    del t, loc, pcol
    torch.cuda.empty_cache()
    return row


def tile_half_ms(kernels, tiles, x, trans_b, x_first, torch):
    """CUDA-event ms of a panel kernel's tile solve alone: its tile_gemm
    launch (mode set, x shared through stride 0; x_first: x @ tiles, as
    lu_rowsolve_tiles, else tiles @ op(x))."""
    out = torch.empty(tiles.shape, dtype=tiles.dtype, device="cuda")
    tb, x3 = kernels._tile_batch, x[None, None, None]
    if x_first:
        c, a, b = tb(out).unsqueeze(2), x3, tb(tiles)
    else:
        c, a, b = tb(out).unsqueeze(3), tb(tiles), x3
    return cuda_ms(lambda: kernels._tile_gemm(c, a, b, None, trans_b=trans_b,
                                              mode=kernels._MODE_SET, who="tile half"), 20, torch)


def hold_chol_panel(name, dtile, pcol, kernels, torch):
    """chol_panel_tiles on (dtile, pcol) against its twin: L at its own
    scale and by reconstruction, the solved tiles within panel_solve_tol.
    Returns (the L readings, |dS|, its tolerance, max|solved|)."""
    eps = torch.finfo(dtile.dtype).eps
    lk, sk = kernels.chol_panel_tiles(dtile, pcol)
    torch.cuda.synchronize()
    lp, sp = kernels.chol_panel_tiles_plain(dtile, pcol)
    _, xk = kernels.chol_diag_inv(dtile)  # the L^-1 the panel kernel solved with
    _, xp = kernels.chol_diag_inv_plain(dtile)
    fac = chol_factor_check(dtile, lk, lp, None, None, eps, torch)
    tol_s = panel_solve_tol(pcol, xk, xp, eps)
    smax = float(sp.abs().max())
    err_s = float((sk - sp).abs().max())
    check(bool(torch.isfinite(sk).all()), f"chol_panel_tiles {name}: non-finite output")
    check(tol_s < 1e-2 * smax, f"chol_panel_tiles {name}: tolerance {tol_s} does not separate "
                               f"a wrong output from max|solved| {smax}")
    check(chol_factor_ok(fac), f"chol_panel_tiles {name}: L {fac}")
    check(err_s < tol_s, f"chol_panel_tiles {name}: |dS| {err_s} (tol {tol_s})")
    return fac, err_s, tol_s, smax


def panel_solve_tol(tiles, xk, xp, eps):
    """Bound on |tiles @ xk^T - tiles @ xp^T| as the kernel and the twin
    compute it: each sums nb products, within nb eps (|T| |X|^T) of the exact
    product of its operands, and the two inverses' own difference adds
    |T| |xk - xp|^T.  Elementwise, then the largest."""
    nb = xk.shape[-1]
    t = tiles.abs()
    bound = nb * eps * (t @ xk.abs().T + t @ xp.abs().T) + t @ (xk - xp).abs().T
    return float(bound.max())


def gemm_tol(nb, eps, amax, bmax, cmax):
    """Kernel vs twin of a tile update: two k-ordered FMA sums of nb
    products, whose rounding errors grow as a random walk (a few sqrt(nb)
    eps max|a| max|b|), plus one rounding each of the final add/subtract
    (cmax: the largest |c| before or after).  A TF32 product (10-bit
    mantissa, ~4e3 f32 eps) lies far outside it."""
    return 8 * math.sqrt(nb) * eps * amax * bmax + 2 * eps * cmax


def rate(flops, row):
    """A kernel's achieved TFLOP/s and the fraction of its bound it reaches
    (bound_ms / ms), from its kernels-line row."""
    return {"tflops": flops / row["ms"] / 1e9, "bound_fraction": row["bound_ms"] / row["ms"]}


def update_calls(which, kernels, pan, rhs, mask, torch):
    """(run, plain, library, replaces) of one tile-update kernel: run and
    plain update the view they are given in place."""
    if which == "chol_trailing_update":
        return (lambda v: kernels.chol_trailing_update(v, pan, rhs, mask),
                lambda v: kernels.chol_trailing_update_plain(v, pan, rhs, mask),
                lambda: torch.matmul(pan.unsqueeze(-3), rhs.unsqueeze(-4).transpose(-1, -2)),
                "slate_tpu/ops/pallas_ops.py:738")
    if which == "lu_trailing_update":
        return (lambda v: kernels.lu_trailing_update(v, pan, rhs, mask),
                lambda v: kernels.lu_trailing_update_plain(v, pan, rhs, mask),
                lambda: torch.matmul(pan.unsqueeze(-3), rhs.unsqueeze(-4)),
                "slate_tpu/ops/pallas_ops.py:777")
    return (lambda v: kernels.summa_update(v, pan, rhs),
            lambda v: kernels.summa_update_plain(v, pan, rhs),
            lambda: torch.matmul(pan.unsqueeze(-3), rhs.unsqueeze(-4)),
            "slate_tpu/ops/pallas_ops.py:711")


def hold_update(which, name, loc, pan, rhs, mask, run, plain, torch):
    """The kernel's update of ``loc`` against the twin's from the same start
    (``loc`` is restored after each): within gemm_tol, the masked tiles
    untouched.  Returns (err, tol, untouched)."""
    eps = torch.finfo(loc.dtype).eps
    before = loc.clone()
    run(loc)
    torch.cuda.synchronize()
    got = loc.clone()
    loc.copy_(before)
    plain(loc)
    want = loc.clone()
    loc.copy_(before)
    tol = gemm_tol(loc.shape[-1], eps, float(pan.abs().max()), float(rhs.abs().max()),
                   max(float(before.abs().max()), float(want.abs().max())))
    err = float((got - want).abs().max())
    keep = ~mask
    untouched = bool(torch.equal(got[keep], before[keep])) if bool(keep.any()) else True
    del got, want, before
    check(err < tol, f"{which} {name}: kernel vs twin {err} (tol {tol})")
    check(untouched, f"{which} {name}: the kernel wrote a masked tile")
    return err, tol, untouched


def update_row(which, dtype, loc, pan, rhs, mask, err, torch, calls, reps=5):
    """Kernel, twin and library times of a tile update and its kernels-line
    row (launches None: the caller reads them from the path)."""
    run, plain, library, replaces = calls
    ms = cuda_ms(lambda: run(loc), reps, torch)
    plain_ms = cuda_ms(lambda: plain(loc), 2, torch)
    library_ms = cuda_ms(library, 3, torch)
    live = int(mask.sum())
    nb = loc.shape[-1]
    isz = loc.element_size()
    nbytes = (pan.numel() + rhs.numel() + 2 * live * nb * nb) * isz + mask.numel() * 4
    flops = 2 * nb ** 3 * live
    return row_of(which, dtype, "slate_tpu_torch/csrc/tile_gemm.cu", replaces, err, ms, plain_ms,
                  library_ms, nbytes, flops), live


def kernel_update_phase(which, dtype, kernels, local_view, local_indices, torch):
    """chol_trailing_update (bucket-0 view of the mesh posv, lower-tile
    mask), lu_trailing_update (bucket-0 view of the mesh LU, the lookahead
    exclusions of one row and one column slot) or summa_update (the mesh
    gemm's accumulator) against its twin."""
    name = dname(dtype)
    n = GEMM_N if which == "summa_update" else MESH_N[name]
    t, loc = mesh_tiles(n, dtype, SEED + 21, torch, local_view)
    _, _, I, J, _, _ = loc.shape
    pan = randn((P, 1, I, NB, NB), dtype, SEED + 22, torch, 0.1)
    rhs = randn((1, Q, J, NB, NB), dtype, SEED + 23, torch, 0.1)
    if which == "chol_trailing_update":
        _, _, i_log, j_log = local_indices(P, Q, I, J, "cuda")
        mask = i_log[:, :, :, None] >= j_log[:, :, None, :]  # the trailing lower tiles
    else:
        mask = torch.ones((P, Q, I, J), dtype=torch.bool, device="cuda")
        if which == "lu_trailing_update":
            mask[:, :, 1, :] = False  # excl_kr
            mask[:, :, :, 1] = False  # excl_kc
    calls = update_calls(which, kernels, pan, rhs, mask, torch)
    err, tol, untouched = hold_update(which, name, loc, pan, rhs, mask, calls[0], calls[1], torch)
    row, live = update_row(which, dtype, loc, pan, rhs, mask, err, torch, calls)
    emit({"phase": f"kernel_{which}_{name}", "grid": [P, Q, I, J], "unmasked_tiles": live,
          "err": err, "tol": tol, "masked_untouched": untouched, "kernel_ms": row["ms"],
          "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
          **rate(2 * NB ** 3 * live, row)})
    del t, loc
    torch.cuda.empty_cache()
    return row


EDGE_NB = (1, 7, 33, 100, 129, 200)  # ragged against both CTA blocks; 100 and 200 whole vectors


def buffer_view(shape, dtype, seed, off, torch, scale=1.0):
    """randn of ``shape`` in a fresh buffer, starting ``off`` elements into
    it: off 0 is 16-byte aligned, off 1 is not (the element copies)."""
    buf = torch.empty(math.prod(shape) + off, dtype=dtype, device="cuda")
    v = buf[off:].view(shape)
    v.copy_(randn(shape, dtype, seed, torch, scale))
    return v


def finite_max(*xs):
    """The largest |x| over the finite entries of xs (0 if none)."""
    return max(float(x.abs().nan_to_num(0.0, 0.0, 0.0).max()) for x in xs)


def tile_mma_edges_phase(kernels, testing, torch):
    """The tile-GEMM core (csrc/tile_mma.cuh) at ragged nb, in both load
    forms: for each dtype, nb in EDGE_NB and a view at offset 0 (16-byte
    copies where nb allows) and 1 element (element copies), the three
    update modes and the three panel-solve launch forms (mode set with a
    shared operand) against their twins within gemm_tol; masked tiles
    holding NaN come back bitwise, a NaN row reaches exactly the outputs the
    twin's does; ft_summa_update against its twin (ft_summa_check) and
    bitwise equal across two launches."""
    t0 = time.perf_counter()
    worst, loads, cases = 0.0, {"16-byte": 0, "element": 0}, 0
    for dt in (torch.float32, torch.float64):
        eps = torch.finfo(dt).eps
        for nb in EDGE_NB:
            for off in (0, 1):
                tag = f"{dname(dt)} nb={nb} off={off}"
                seed = SEED + 300 + nb + 7 * off
                c = buffer_view((P, Q, 2, 3, nb, nb), dt, seed, off, torch)
                pan = buffer_view((P, 1, 2, nb, nb), dt, seed + 1, off, torch, 0.5)
                rhs = buffer_view((1, Q, 3, nb, nb), dt, seed + 2, off, torch, 0.5)
                pan[0, 0, 0, min(3, nb - 1), 0] = float("nan")
                g = torch.Generator(device="cuda").manual_seed(seed)
                mask = torch.rand((P, Q, 2, 3), generator=g, device="cuda") < 0.6
                c[~mask] = float("nan")
                for x in (pan, rhs):
                    loads["16-byte" if kernels._load16(x, nb) else "element"] += 1
                for which in ("summa_update", "chol_trailing_update", "lu_trailing_update"):
                    run, plain, _, _ = update_calls(which, kernels, pan, rhs, mask, torch)
                    before = c.clone()
                    run(c)
                    torch.cuda.synchronize()
                    got = c.clone()
                    c.copy_(before)
                    plain(c)
                    want = c.clone()
                    c.copy_(before)
                    check(torch.equal(got.isnan(), want.isnan()),
                          f"edges {which} {tag}: NaN masks differ")
                    fin = want.isfinite()
                    tol = gemm_tol(nb, eps, finite_max(pan), float(rhs.abs().max()),
                                   max(finite_max(before), finite_max(want)))
                    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
                    check(err <= tol, f"edges {which} {tag}: {err} (tol {tol})")
                    worst = max(worst, err / tol)
                    if which != "summa_update":
                        bits = torch.int32 if dt == torch.float32 else torch.int64
                        check(torch.equal(got[~mask].view(bits), before[~mask].view(bits)),
                              f"edges {which} {tag}: a masked tile moved")
                    cases += 1
                # mode set, one operand shared through stride 0: the three
                # panel solves' launch forms (A_i X^T, A_i X, X A_j)
                tiles = buffer_view((P, 1, 3, nb, nb), dt, seed + 3, off, torch)
                x = buffer_view((nb, nb), dt, seed + 4, off, torch)
                x3 = x[None, None, None]
                for form, out_shape, a, b, trans, want in (
                        ("a_xt", (P, 1, 3, 1, nb, nb), tiles, x3, True, tiles @ x.T),
                        ("a_x", (P, 1, 3, 1, nb, nb), tiles, x3, False, tiles @ x),
                        ("x_a", (P, 1, 1, 3, nb, nb), x3, tiles, False, x @ tiles)):
                    out = torch.full(out_shape, float("nan"), dtype=dt, device="cuda")
                    kernels._tile_gemm(out, a, b, None, trans_b=trans, mode=kernels._MODE_SET,
                                       who=f"edges {form}")
                    torch.cuda.synchronize()
                    got = out[:, :, :, 0] if form != "x_a" else out[:, :, 0]
                    tol = gemm_tol(nb, eps, float(tiles.abs().max()), float(x.abs().max()),
                                   float(want.abs().max()))
                    err = float((got - want).abs().max())
                    check(err <= tol, f"edges {form} {tag}: {err} (tol {tol})")
                    worst = max(worst, err / tol)
                    cases += 1
                # the ABFT step: against its twin, and bitwise across launches
                acc = buffer_view((P, Q, 3, 2, nb, nb), dt, seed + 5, off, torch, 10.0)
                fpan = buffer_view((P, 1, 3, nb, nb), dt, seed + 6, off, torch)
                urow = buffer_view((1, Q, 2, nb, nb), dt, seed + 7, off, torch)
                part = buffer_view((P, Q, 2, 2, nb, nb), dt, seed + 8, off, torch, 100.0)
                w1 = torch.tensor([1.0, 1.0, 0.0], dtype=dt, device="cuda").view(1, 1, 3)
                w2 = w1 * torch.arange(1, 4, dtype=dt, device="cuda")
                one = kernels.ft_summa_update(acc.clone(), fpan, urow, w1, w2, part.clone())
                two = kernels.ft_summa_update(acc.clone(), fpan, urow, w1, w2, part.clone())
                torch.cuda.synchronize()
                check(torch.equal(one[0], two[0]) and torch.equal(one[1], two[1]),
                      f"edges ft_summa_update {tag}: two launches differ")
                want = kernels.ft_summa_update_plain(acc.clone(), fpan, urow, w1, w2, part.clone())
                readings = testing.ft_summa_check(acc, fpan, urow, w1, w2, part, one, want)
                check(all(v <= 1 for v in readings.values()),
                      f"edges ft_summa_update {tag}: {readings}")
                worst = max(worst, *readings.values())
                cases += 1
    check(loads["16-byte"] and loads["element"], f"edges: a load form went untested {loads}")
    emit({"phase": "tile_mma_edges", "nb": list(EDGE_NB), "cases": cases, "loads": loads,
          "worst_ratio": worst, "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()


COUNTED = ("chol_diag_inv", "chol_panel_tiles", "chol_trailing_update", "summa_update",
           "lu_panel_tiles", "lu_rowsolve_tiles", "lu_trailing_update", "qr_panel",
           "qr_panel_offset", "ft_summa_update", "transpose_tiles", "geadd_tiles",
           "genorm_max_tiles", "matmul_pallas")


def reset_counts(kernels):
    for name in COUNTED:
        getattr(kernels, name).launches = 0


def read_counts(kernels):
    return {name: getattr(kernels, name).launches for name in COUNTED}


def expected_potrf_launches(nt, la, bucket_plan):
    """Launches of one potrf_dist, derived from its loop: one panel per
    step; per bucket of s steps, s bulk updates and, at lookahead >= 1, s
    narrow refreshes plus one drain."""
    panel = trailing = 0
    for k0, k1, _, _ in bucket_plan(nt, P, Q):
        s = k1 - k0
        panel += s
        trailing += s + (s + 1 if la >= 1 else 0)
    return {"chol_panel_tiles": panel, "chol_trailing_update": trailing}


def mesh_posv_phase(dtype, kernels, mp, bucket_plan, torch):
    """from_dense -> potrf_dist -> two trsm_dist (the solve, timed) ->
    gemm_summa residual, at the size users run on one card."""
    from slate_tpu_torch.types import Diag, Op, Uplo

    name = dname(dtype)
    n = MESH_N[name]
    mesh = mp.make_mesh(P, Q, device="cuda")
    a = dominant_spd(n, dtype, SEED + 31, torch)
    b = torch.randn((n, NRHS), generator=torch.Generator(device="cuda").manual_seed(SEED + 32),
                    dtype=dtype, device="cuda")

    def solve(split):
        """The solve; ``split`` collects the seconds of each step (a
        synchronise after each, a few microseconds)."""
        t = time.perf_counter()

        def mark(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            split[name] = now - t
            t = now

        ad = mp.from_dense(a, mesh, NB, diag_pad_one=True)
        bd = mp.from_dense(b, mesh, NB)
        mark("from_dense")
        l, info = mp.potrf_dist(ad, overwrite_a=True)
        mark("potrf_dist")
        y = mp.trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, Diag.NonUnit)
        mark("trsm_dist_lower")
        x = mp.trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, Diag.NonUnit)
        mark("trsm_dist_upper")
        return l, x, info

    l, x, info = solve({})  # warm-up: handles, allocator, kernel loads
    del l, x, info
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    split = {}
    t0 = time.perf_counter()
    l, x, info = solve(split)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del l
    t1 = time.perf_counter()
    ax = mp.to_dense(mp.gemm_summa(1.0, mp.from_dense(a, mesh, NB), x))
    torch.cuda.synchronize()
    residual_seconds = time.perf_counter() - t1
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    xd = mp.to_dense(x)
    e = float((ax - b).abs().max() / (a.abs().max() * xd.abs().max() * n + b.abs().max()))
    gate = 100 * n * torch.finfo(dtype).eps
    nt = n // NB
    want = expected_potrf_launches(nt, 1, bucket_plan)
    emit({"phase": f"mesh_posv_{name}", "n": n, "nrhs": NRHS, "nb": NB, "grid": [P, Q],
          "info": int(info), "eta": e, "eta_gate": gate, "launches": counts,
          "expected_launches": want, "solve_seconds": seconds, "split_seconds": split,
          "residual_seconds": residual_seconds, "peak_mem_bytes": peak,
          "x_finite": bool(torch.isfinite(xd).all())})
    check(int(info) == 0, f"mesh posv {name}: info {int(info)}")
    check(e < gate, f"mesh posv {name}: eta {e} >= {gate}")
    check(tuple(xd.shape) == (n, NRHS) and bool(torch.isfinite(xd).all()),
          f"mesh posv {name}: bad solution")
    for k, v in want.items():
        check(counts[k] == v, f"mesh posv {name}: {counts[k]} {k} launches, expected {v}")
    del a, b, x, xd, ax
    torch.cuda.empty_cache()
    return counts


def mesh_gemm_phase(kernels, mp, torch):
    from slate_tpu_torch.types import MethodGemm, select_gemm_method

    dtype = torch.float32
    n = GEMM_N
    mesh = mp.make_mesh(P, Q, device="cuda")
    a = randn((n, n), dtype, SEED + 41, torch)
    b = randn((n, n), dtype, SEED + 42, torch)
    ad, bd = mp.from_dense(a, mesh, NB), mp.from_dense(b, mesh, NB)
    method = select_gemm_method(ad.mt, bd.nt, ad.nt)
    check(method == MethodGemm.GemmC, f"mesh gemm: {method} selected, expected GemmC")
    mp.gemm_summa(1.0, ad, bd)  # warm-up
    torch.cuda.synchronize()
    reset_counts(kernels)
    t0 = time.perf_counter()
    c = mp.gemm_summa(1.0, ad, bd)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    del ad, bd
    cd = mp.to_dense(c)
    del c
    ref = torch.matmul(a, b)  # full f32 (TF32 off)
    rel = float((cd - ref).abs().max() / ref.abs().max())
    # f32 sums of k = 16384 products in two orders differ by ~sqrt(k) eps
    # relative to the largest entry; a TF32 product would be ~10x the gate
    gate = 4 * math.sqrt(n) * torch.finfo(dtype).eps
    emit({"phase": "mesh_gemm_float32", "n": n, "nb": NB, "grid": [P, Q], "method": method.name,
          "rel_err_vs_matmul": rel, "gate": gate, "launches": counts, "seconds": seconds,
          "tflops": 2 * n ** 3 / seconds / 1e12})
    check(rel < gate, f"mesh gemm: relative error {rel} >= {gate}")
    check(counts["summa_update"] == n // NB,
          f"mesh gemm: {counts['summa_update']} summa_update launches, expected {n // NB}")
    del a, b, cd, ref
    torch.cuda.empty_cache()
    return counts


def mesh_invariants_phase(mp, posv_chain, torch):
    """Bitwise across lookahead depths and broadcast lowerings (the whole
    chain), and the non-SPD info rule (1 + the first bad pivot)."""
    n = INVARIANT_N
    mesh = mp.make_mesh(P, Q, device="cuda")
    a = dominant_spd(n, torch.float32, SEED + 51, torch)
    b = randn((n, NRHS), torch.float32, SEED + 52, torch)
    runs = {}
    for la in (0, 1, 2):
        runs[f"lookahead{la}"] = posv_chain(a, b, mesh, NB, lookahead=la)[0]
    for impl in ("psum", "ring", "doubling"):
        runs[f"bcast_{impl}"] = posv_chain(a, b, mesh, NB, bcast_impl=impl)[0]
    base = runs["lookahead1"]
    equal = {k: bool(torch.equal(v, base)) for k, v in runs.items()}
    j = 9 * NB + 77  # inside diagonal tile 9, step 9 of bucket 2
    bad = a.clone()
    bad[j, j] = -1.0
    _, info = mp.potrf_dist(mp.from_dense(bad, mesh, NB, diag_pad_one=True))
    emit({"phase": "mesh_invariants", "n": n, "bitwise_equal": equal, "non_spd_info": int(info),
          "expected_info": j + 1})
    check(all(equal.values()), f"mesh invariants: not bitwise equal: {equal}")
    check(int(info) == j + 1, f"mesh invariants: non-SPD info {int(info)}, expected {j + 1}")
    del a, b, bad, runs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the LU slice: the three LU kernels and the three mesh LU solves
# ---------------------------------------------------------------------------


def lu_block(nb, dtype, seed, torch):
    """A diagonal block that factors stably without pivoting: randn + nb I."""
    g = randn((nb, nb), torch.float64, seed, torch)
    g.diagonal().add_(nb)
    return g.to(dtype)


def solve_tol(tiles, xk, xp, eps, left):
    """Bound on |tiles @ xk - tiles @ xp| (``left``: |xk @ tiles - xp @ tiles|)
    as the kernel and the twin compute it: each sums nb products, within
    nb eps of the exact product of its operands, and the two inverses' own
    difference adds its product with |tiles|.  Elementwise, the largest."""
    nb = xk.shape[-1]
    t = tiles.abs()
    if left:
        bound = nb * eps * (xk.abs() @ t + xp.abs() @ t) + (xk - xp).abs() @ t
    else:
        bound = nb * eps * (t @ xk.abs() + t @ xp.abs()) + t @ (xk - xp).abs()
    return float(bound.max())


def lu_factor_check(a, lk, lp, eps, torch):
    """The kernel's packed L\\U ``lk`` of block ``a`` against the twin's
    ``lp`` and against ``a`` itself.  L (strict lower) and U (upper) each
    hold to 100 nb eps of the twin's largest entry of that factor: the
    entries of L are ~1/nb of U's, so one limit for both would pass a zero
    L.  U's largest entry is its diagonal (~nb for randn + nb I), so the
    off-diagonal entries are held by the reconstruction: LU - A, the product
    taken in f64, within 3 nb eps |L||U| elementwise.  That is the backward
    error bound of an LU in any summation order (gamma_nb, unit roundoff
    eps / 2) plus the check's own product, with room; a factor with L zero
    or off by 1e-3 relative fails it.  Returns the readings and limits."""
    nb = a.shape[-1]
    lo_k, lo_p, up_k, up_p = lk.tril(-1), lp.tril(-1), lk.triu(), lp.triu()
    lmax, umax = float(lo_p.abs().max()), float(up_p.abs().max())
    l64 = lk.double().tril(-1) + torch.eye(nb, dtype=torch.float64, device=lk.device)
    u64 = lk.double().triu()
    res = (l64 @ u64 - a.double()).abs()
    bound = 3 * nb * eps * (l64.abs() @ u64.abs())
    ratio = torch.nan_to_num(res / bound, nan=0.0, posinf=float("inf"))  # 0/0: exact
    return {"err_L": float((lo_k - lo_p).abs().max()), "tol_L": 100 * nb * eps * lmax,
            "max_abs_L": lmax, "err_U": float((up_k - up_p).abs().max()),
            "tol_U": 100 * nb * eps * umax, "max_abs_U": umax,
            "rec_ratio": float(ratio.max()), "rec_rel_limit": 3 * nb * eps}


def lu_factor_ok(c):
    """Each limit separates a wrong factor (below 1e-2 of what it holds)
    and each reading is within its limit."""
    return (c["tol_L"] < 1e-2 * c["max_abs_L"] and c["tol_U"] < 1e-2 * c["max_abs_U"]
            and c["rec_rel_limit"] < 1e-2 and c["err_L"] < c["tol_L"] and c["err_U"] < c["tol_U"]
            and c["rec_ratio"] <= 1)


def hold_lu_rowsolve(name, lk, prow, kernels, torch):
    """lu_rowsolve_tiles on (packed L\\U ``lk``, row tiles ``prow``) against
    its twin within solve_tol, with the unit-L^-1 it solved with read by
    applying the kernel to the identity (L^-1 I is exact for a finite
    inverse).  Returns (|dS|, its tolerance, max|solved|)."""
    eps = torch.finfo(lk.dtype).eps
    rk = kernels.lu_rowsolve_tiles(lk, prow)
    torch.cuda.synchronize()
    rp = kernels.lu_rowsolve_tiles_plain(lk, prow)
    eye = torch.eye(lk.shape[-1], dtype=lk.dtype, device="cuda")[None]
    linvk = kernels.lu_rowsolve_tiles(lk, eye)[0]
    linvp = kernels.unit_linv_plain(lk)
    tol_r = solve_tol(prow, linvk, linvp, eps, left=True)
    rmax = float(rp.abs().max())
    err_r = float((rk - rp).abs().max())
    check(bool(torch.isfinite(rk).all()), f"lu_rowsolve_tiles {name}: non-finite output")
    check(tol_r < 1e-2 * rmax, f"lu_rowsolve_tiles {name}: tolerance {tol_r} does not separate "
                               f"a wrong output from max|solved| {rmax}")
    check(err_r < tol_r, f"lu_rowsolve_tiles {name}: |dS| {err_r} (tol {tol_r})")
    return err_r, tol_r, rmax


def lu_edges(dtype, kernels, torch):
    """The LU entry points (csrc/lu_diag_inv.cu, called directly so U^-1 is
    not smeared by a tile product) against their twins at n = 72 and 200:
    L\\U by lu_factor_check, U^-1 and unit-L^-1 within 100 n eps of their
    own largest entry and by U X = I, L Y = I within 3 n eps |U||X|; their
    structural triangles exact zeros; and with row j zero (U(j, j) = 0) at
    j = 31 and 32, L\\U finite and U^-1 finite exactly where the twin's is.
    Returns the largest reading of each kind."""
    eps = torch.finfo(dtype).eps
    worst = {"err_ratio": 0.0, "rec_ratio": 0.0, "inv_ratio": 0.0}

    def entries(b):
        lu, ux, lx = torch.empty_like(b), torch.empty_like(b), torch.empty_like(b)
        kernels._launch_lu("lu_diag_inv", "lu_edges", b, lu, ux)
        kernels._launch_lu("unit_linv", "lu_edges", lu, lx)
        torch.cuda.synchronize()
        return lu, ux, lx

    for n in EDGE_N:
        b = lu_block(n, dtype, SEED + 200 + n, torch)
        lu, ux, lx = entries(b)
        lup, uxp = kernels.lu_diag_inv_plain(b)
        lxp = kernels.unit_linv_plain(lu)
        fac = lu_factor_check(b, lu, lup, eps, torch)
        check(lu_factor_ok(fac), f"lu_diag_inv {dname(dtype)} n={n}: packed L\\U {fac}")
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        lo = lu.double().tril(-1) + eye
        up = lu.double().triu()
        readings = [float((ux - uxp).abs().max()) / (100 * n * eps * float(uxp.abs().max())),
                    float((lx - lxp).abs().max()) / (100 * n * eps * float(lxp.abs().max()))]
        inv = max(residual_ratio(up, ux.double(), eye, n, eps, torch),
                  residual_ratio(lo, lx.double(), eye, n, eps, torch))
        check(max(readings) <= 1 and inv <= 1, f"lu_diag_inv {dname(dtype)} n={n}: inverses "
                                               f"{readings}, residual {inv}")
        check(torch.equal(ux.tril(-1), torch.zeros_like(ux).tril(-1))
              and torch.equal(lx.triu(1), torch.zeros_like(lx).triu(1)),
              f"lu_diag_inv {dname(dtype)} n={n}: structural triangle not exactly zero")
        worst["err_ratio"] = max(worst["err_ratio"], fac["err_L"] / fac["tol_L"],
                                 fac["err_U"] / fac["tol_U"], *readings)
        worst["rec_ratio"] = max(worst["rec_ratio"], fac["rec_ratio"])
        worst["inv_ratio"] = max(worst["inv_ratio"], inv)
        for j in EDGE_COLS:
            z = b.clone()
            z[j, :] = 0
            lz, uz, lxz = entries(z)
            _, uzp = kernels.lu_diag_inv_plain(z)
            check(bool(torch.isfinite(lz).all()) and float(lz[j, j]) == 0.0
                  and torch.equal(torch.isfinite(uz), torch.isfinite(uzp))
                  and bool(torch.isfinite(lxz).all()),
                  f"lu_diag_inv {dname(dtype)} n={n}: zero-pivot pattern at {j}")
    return worst


def kernel_lu_panel_phase(dtype, kernels, local_view, torch):
    """lu_panel_tiles (the owning column's p x mtl tiles of the mesh LU's
    bucket-0 view) and lu_rowsolve_tiles (the owning row's q x ntl tiles)
    against their twins, strided as the driver slices them."""
    name = dname(dtype)
    eps = torch.finfo(dtype).eps
    n = MESH_N[name]
    t, loc = mesh_tiles(n, dtype, SEED + 61, torch, local_view)
    pcol = loc[:, 1:2, :, 1]  # (p, 1, mtl, nb, nb)
    prow = loc[1:2, :, 2]  # (1, q, ntl, nb, nb)
    dtile = lu_block(NB, dtype, SEED + 62, torch)
    lk, sk = kernels.lu_panel_tiles(dtile, pcol)
    torch.cuda.synchronize()
    lp, sp = kernels.lu_panel_tiles_plain(dtile, pcol)
    # the U^-1 the kernel solved with: the kernel applied to the identity
    # (I U^-1 is exact for a finite inverse)
    eye = torch.eye(NB, dtype=dtype, device="cuda")[None]
    uk = kernels.lu_panel_tiles(dtile, eye)[1][0]
    _, up = kernels.lu_diag_inv_plain(dtile)
    fac = lu_factor_check(dtile, lk, lp, eps, torch)
    # solved tiles: solve_tol, which must separate a wrong output from the
    # largest solved value
    tol_s = solve_tol(pcol, uk, up, eps, left=False)
    smax = float(sp.abs().max())
    err_l = max(fac["err_L"], fac["err_U"])
    err_s = float((sk - sp).abs().max())
    check(bool(torch.isfinite(sk).all()), f"lu_panel_tiles {name}: non-finite output")
    check(tol_s < 1e-2 * smax, f"lu_panel_tiles {name}: tolerance {tol_s} does not separate a "
                               f"wrong output from max|solved| {smax}")
    check(lu_factor_ok(fac), f"lu_panel_tiles {name}: packed L\\U {fac}")
    check(err_s < tol_s, f"lu_panel_tiles {name}: |dS| {err_s} (tol {tol_s})")
    err_r, tol_r, rmax = hold_lu_rowsolve(name, lk, prow, kernels, torch)
    edges = lu_edges(dtype, kernels, torch)
    isz = dtile.element_size()
    rows = []
    for kname, run, plain, library, err, tiles, flops, nbytes, replaces in (
            ("lu_panel_tiles", lambda: kernels.lu_panel_tiles(dtile, pcol),
             lambda: kernels.lu_panel_tiles_plain(dtile, pcol),
             lambda: torch.linalg.solve_triangular(
                 torch.linalg.lu_factor_ex(dtile, pivot=False)[0].triu(), pcol, upper=True,
                 left=False),
             max(err_l, err_s), pcol,
             # factor 2 nb^3 / 3 + U^-1 nb^3 / 3, then one product with the
             # triangular U^-1 per tile, nb^3
             NB ** 3 + NB ** 3 * pcol.shape[0] * pcol.shape[2],
             # the block read, L\U written, each tile read and written once
             (2 * NB * NB + 2 * pcol.shape[0] * pcol.shape[2] * NB * NB) * isz,
             "slate_tpu/ops/pallas_ops.py:543"),
            ("lu_rowsolve_tiles", lambda: kernels.lu_rowsolve_tiles(lk, prow),
             lambda: kernels.lu_rowsolve_tiles_plain(lk, prow),
             lambda: torch.linalg.solve_triangular(lk, prow, upper=False, left=True,
                                                   unitriangular=True),
             err_r, prow,
             # unit-L^-1 nb^3 / 3, then one triangular product per tile, nb^3
             NB ** 3 / 3 + NB ** 3 * prow.shape[1] * prow.shape[2],
             # the strict lower triangle read, each tile read and written once
             (NB * (NB - 1) // 2 + 2 * prow.shape[1] * prow.shape[2] * NB * NB) * isz,
             "slate_tpu/ops/pallas_ops.py:590")):
        ms = cuda_ms(run, 20, torch)
        plain_ms = cuda_ms(plain, 2, torch)
        library_ms = cuda_ms(library, 20, torch)
        row = row_of(kname, dtype, "slate_tpu_torch/csrc/lu_diag_inv.cu", replaces, err, ms,
                     plain_ms, library_ms, nbytes, flops)
        rows.append(row)
        if kname == "lu_panel_tiles":
            tile_ms = tile_half_ms(kernels, pcol, uk, False, False, torch)
        else:
            tile_ms = tile_half_ms(kernels, prow, kernels.unit_linv_plain(lk), False, True, torch)
        emit({"phase": f"kernel_{kname}_{name}", "tiles": list(tiles.shape),
              "err_solved": err_s if kname == "lu_panel_tiles" else err_r,
              "tol_solved": tol_s if kname == "lu_panel_tiles" else tol_r,
              "max_abs_solved": smax if kname == "lu_panel_tiles" else rmax,
              **(fac if kname == "lu_panel_tiles" else {"edges": edges}), "kernel_ms": ms,
              "tile_ms": tile_ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": row["bound_ms"],
              "bound_by": row["bound_by"]})
    del t, loc, pcol, prow
    torch.cuda.empty_cache()
    return rows


LU_KERNELS = ("lu_panel_tiles", "lu_rowsolve_tiles", "lu_trailing_update")
MESH_LU_N = {("nopiv", "float32"): 32768, ("nopiv", "float64"): 16384,
             ("pp", "float32"): 32768, ("pp", "float64"): 16384,
             ("tntpiv", "float32"): 8192}
WARMUP_N = 2048


def expected_lu_launches(form, nt, la, bucket_plan):
    """Launches of one LU factor, derived from its loop.  No pivoting: one
    panel column and one panel row per step; per bucket of s steps, s bulk
    updates at lookahead 0, and at lookahead >= 1 s - 1 narrow refreshes
    of two launches (column and row; the first step carries no update),
    s - 1 bulk updates and the drain.  Tournament: nt panels and rows, the
    update pinned to the matmul form.  Partial pivot: nt panel rows only
    (its column factor is torch ops)."""
    if form == "pp":
        return {"lu_panel_tiles": 0, "lu_rowsolve_tiles": nt, "lu_trailing_update": 0}
    if form == "tntpiv":
        return {"lu_panel_tiles": nt, "lu_rowsolve_tiles": nt, "lu_trailing_update": 0}
    trailing = 0
    for k0, k1, _, _ in bucket_plan(nt, P, Q):
        s = k1 - k0
        trailing += (3 * s - 2) if la >= 1 else s
    return {"lu_panel_tiles": nt, "lu_rowsolve_tiles": nt, "lu_trailing_update": trailing}


def omega(a, x, b, torch, rows=4096):
    """Componentwise backward error (Oettli-Prager) max_i |AX - B|_i /
    (|A||X| + |B|)_i, the residual taken in f64 over blocks of rows, so the
    check adds no rounding of its size.  A right-sized but wrong X reads
    ~1/sqrt(n) or more (the operand's own scale cancels out); a NaN in X
    reads NaN, which fails every gate (max() would drop it)."""
    x64, w = x.double(), 0.0
    for r0 in range(0, a.shape[0], rows):
        a64, b64 = a[r0:r0 + rows].double(), b[r0:r0 + rows].double()
        r = (a64 @ x64 - b64).abs()
        m = float((r / (a64.abs() @ x64.abs() + b64.abs())).max())
        if math.isnan(m):
            return m
        w = max(w, m)
    return w


def omega_gate(n, dtype, torch):
    """The tighter gate on the LU solves: 10 sqrt(n) eps.  The n-term sums
    of a backward-stable factor and solve round as a random walk (sqrt(n)
    eps), with a factor 10 for pivot growth; a wrong X of the right size
    reads ~1/sqrt(n) or more, >= 100x the gate at n = 32768."""
    return 10 * math.sqrt(n) * torch.finfo(dtype).eps


def lu_matrix(form, n, dtype, seed, torch):
    """uniform[-1, 1), plus n I for the no-pivot solve, made on the device."""
    a = torch.rand((n, n), generator=torch.Generator(device="cuda").manual_seed(seed),
                   dtype=dtype, device="cuda")
    a.mul_(2).sub_(1)
    if form == "nopiv":
        a.diagonal().add_(n)
    return a


def mesh_lu_phase(form, dtype, kernels, mp, bucket_plan, torch):
    """getrf_*_mesh -> permute_rows_dist -> two trsm_dist (the gesv_*_mesh
    solve, timed step by step) on a virtual 2 x 4 mesh, after a warm-up
    gesv_*_mesh at n = 2048; then the backward error of the solution."""
    from slate_tpu_torch.types import Diag, Op, Option, Uplo

    name = dname(dtype)
    n = MESH_LU_N[(form, name)]
    mesh = mp.make_mesh(P, Q, device="cuda")
    opts = {Option.MixedPrecision: "off"}
    getrf = {"nopiv": mp.getrf_nopiv_mesh, "pp": mp.getrf_mesh, "tntpiv": mp.getrf_tntpiv_mesh}[form]
    gesv = {"nopiv": mp.gesv_nopiv_mesh, "pp": mp.gesv_mesh, "tntpiv": mp.gesv_tntpiv_mesh}[form]
    aw = lu_matrix(form, WARMUP_N, dtype, SEED + 70, torch)
    xw, infow = gesv(aw, aw[:, :NRHS].clone(), mesh, NB, opts=opts)  # handles, allocator, kernel loads
    check(int(infow) == 0 and bool(torch.isfinite(xw).all()), f"mesh {form} {name}: warm-up failed")
    del aw, xw
    a = lu_matrix(form, n, dtype, SEED + 71, torch)
    b = randn((n, NRHS), dtype, SEED + 72, torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    split = {}
    t0 = t = time.perf_counter()

    def mark(step):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[step] = now - t
        t = now

    out = getrf(a, mesh, NB, opts=opts)
    mark("getrf")
    lu, info = out[0], out[-1]
    bd = mp.from_dense(b, mesh, NB)
    if form != "nopiv":
        bd = mp.permute_rows_dist(bd, out[1])
    mark("from_dense_permute")
    y = mp.trsm_dist(lu, bd, Uplo.Lower, Op.NoTrans, Diag.Unit)
    mark("trsm_dist_lower")
    x = mp.to_dense(mp.trsm_dist(lu, y, Uplo.Upper, Op.NoTrans))
    mark("trsm_dist_upper")
    seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    del lu, y, bd, out
    e = eta(a, x, b, torch)
    gate = 100 * n * torch.finfo(dtype).eps
    w, w_gate = omega(a, x, b, torch), omega_gate(n, dtype, torch)
    nt = n // NB
    want = expected_lu_launches(form, nt, 1, bucket_plan)
    emit({"phase": f"mesh_gesv_{form}_{name}", "n": n, "nrhs": NRHS, "nb": NB, "grid": [P, Q],
          "info": int(info), "eta": e, "eta_gate": gate, "omega": w, "omega_gate": w_gate,
          "launches": counts,
          "expected_launches": want, "solve_seconds": seconds, "split_seconds": split,
          "peak_mem_bytes": peak, "x_finite": bool(torch.isfinite(x).all())})
    check(int(info) == 0, f"mesh {form} {name}: info {int(info)}")
    check(e < gate, f"mesh {form} {name}: eta {e} >= {gate}")
    check(w < w_gate, f"mesh {form} {name}: omega {w} >= {w_gate}")
    check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()),
          f"mesh {form} {name}: bad solution")
    for k, v in want.items():
        check(counts[k] == v, f"mesh {form} {name}: {counts[k]} {k} launches, expected {v}")
    del a, b, x
    torch.cuda.empty_cache()
    return counts


def lu_invariants_phase(mp, torch):
    """No pivoting and partial pivoting: bitwise across lookahead 0/1/2 and
    the psum/ring/doubling lowerings (the whole solve), and a zero column
    j giving info j + 1."""
    from slate_tpu_torch.types import Option

    n = INVARIANT_N
    mesh = mp.make_mesh(P, Q, device="cuda")
    b = randn((n, NRHS), torch.float32, SEED + 81, torch)
    out = {"phase": "lu_invariants", "n": n}
    ok = True
    for form, gesv, getrf in (("nopiv", mp.gesv_nopiv_mesh, mp.getrf_nopiv_mesh),
                              ("pp", mp.gesv_mesh, mp.getrf_mesh)):
        a = lu_matrix(form, n, torch.float32, SEED + 80, torch)
        runs = {}
        for la in (0, 1, 2):
            runs[f"lookahead{la}"] = gesv(a, b, mesh, NB, opts={Option.Lookahead: la})[0]
        for impl in ("psum", "ring", "doubling"):
            runs[f"bcast_{impl}"] = gesv(a, b, mesh, NB, opts={Option.BcastImpl: impl})[0]
        base = runs["lookahead1"]
        equal = {k: bool(torch.equal(v, base)) for k, v in runs.items()}
        j = 9 * NB + 77
        a[:, j] = 0
        info = int(getrf(a, mesh, NB)[-1])
        out[form] = {"bitwise_equal": equal, "zero_column": j, "info": info,
                     "expected_info": j + 1}
        ok = ok and all(equal.values()) and info == j + 1
        del a, runs
        torch.cuda.empty_cache()
    emit(out)
    check(ok, f"LU invariants failed: {out}")


# ---------------------------------------------------------------------------
# the QR slice: the two Householder panel kernels, gels and mesh gels
# ---------------------------------------------------------------------------

# gels on one card and on the virtual 2 x 4 mesh: m = 2n, f64 at half size
GELS_MN = {"float32": (32768, 16384), "float64": (16384, 8192)}
QR_LEAF_W = 64  # linalg.qr._QR_PANEL, the width of geqrf_array's leaves
QR_RECON_MN = (8192, 4096)
QR_WARMUP_MN = (2048, 1024)
GELS_REPEATS = 2  # timed solves after the counted one


def qr_mutants_fail(a, got, want, offset, row0, testing):
    """The sanity case: V zeroed below its pivots, R's off-pivot entries
    zeroed, T's off-diagonal zeroed and a T column doubled each fail the
    reading named for it."""
    muts = testing.qr_panel_mutants(got, offset, row0)
    return all(testing.qr_panel_check(a, mut, want, offset, row0)[k] > 1 for k, mut in muts.items())


def qr_bound(m, w, batch, dtype, offset):
    """(bytes, flops) of the panel function: A read once, the factor (and
    V) written once, tau and T; flops 2 m w^2 for the reflections plus
    m w^2 for the Gram of T."""
    isz = 4 if dtype == "float32" else 8
    nbytes = batch * ((3 if offset else 2) * m * w + w + w * w) * isz
    return nbytes, batch * 3 * m * w * w


def qr_barrier_floor(kernels, dtype, batch, m, w):
    """The panel kernel's floor at a shape: w column exchanges (one a
    column) and two block barriers a 32-column block, each at the measured
    time of one empty round at the launch's grid."""
    ex = kernels.qr_sync_ms(dtype, batch, m, w, "exchange")
    bar = kernels.qr_sync_ms(dtype, batch, m, w, "barrier")
    return {"floor_ms": w * ex + 2 * -(-w // 32) * bar, "exchange_ms": ex, "barrier_ms": bar}


def kernel_qr_edges_phase(kernels, testing, torch):
    """Both QR kernels against their twins at the edge shapes of
    utils.testing (widths off and at the 32-column block, m < w, m ragged
    against the CTA rows, rows a CTA kept in global memory (an f64 panel,
    and eight offset panels a launch in both dtypes); row0 at 0, a middle
    row and m - w for the offset form), each shape with a -0.0 first pivot
    and a dead (zero) column, and with columns zero only below their
    pivots: utils.testing.qr_edge_checks (every qr_panel_check reading
    <= 1, the mutants fail theirs where the panel has off-diagonal parts,
    dead columns keep tau 0 and a zero pivot, rows above row0 stay as A
    has them), and a NaN below the first pivot comes back as the twin's
    NaN tau without a hang."""
    t0 = time.perf_counter()
    worst, cases = {}, 0

    def one(a, got, want, offset, r0, tag, variant):
        nonlocal cases
        c, bad = testing.qr_edge_checks(a, got, want, offset, r0, variant)
        check(not bad, f"qr edges {tag}: {bad} {c}")
        for k in testing.QR_READINGS:
            worst[k] = max(worst.get(k, 0.0), c[k])
        cases += 1

    def offset_batch(dt, m, w, r0s, variant):
        a = torch.stack([torch.from_numpy(testing.qr_edge_panel(m, w, variant, SEED + m + i, r))
                         for i, r in enumerate(r0s)]).to(dt).cuda()
        got = kernels.qr_panel_offset(a, r0s)
        torch.cuda.synchronize()
        want = kernels.qr_panel_offset_plain(a, r0s)
        for i, r in enumerate(r0s):
            one(a[i], tuple(x[i] for x in got), tuple(x[i] for x in want), True, r,
                f"offset {dname(dt)} {len(r0s)}x{m}x{w} row0 {r} {variant}", variant)

    for dt in (torch.float32, torch.float64):
        for m, w in testing.qr_edge_plain(dt):
            for variant in testing.QR_EDGE_VARIANTS:
                tag = f"plain {dname(dt)} {m}x{w} {variant}"
                a = torch.from_numpy(testing.qr_edge_panel(m, w, variant, SEED + m + w)).to(dt).cuda()
                got = kernels.qr_panel(a)
                torch.cuda.synchronize()
                one(a, got, kernels.qr_panel_plain(a), False, 0, tag, variant)
        for m, w in testing.QR_EDGE_OFFSET:
            for variant in testing.QR_EDGE_VARIANTS:
                offset_batch(dt, m, w, testing.qr_edge_row0s(m, w), variant)
        # eight panels a launch: a CTA's rows in global memory, f32 included
        bsz, m, w = testing.QR_EDGE_OFFSET_GLOBAL
        check(testing.qr_rows_in_global(kernels, dt, bsz, m, w),
              f"qr edges {dname(dt)}: {bsz}x{m}x{w} did not take the global-memory form")
        for variant in testing.QR_EDGE_VARIANTS:
            offset_batch(dt, m, w, testing.qr_edge_row0s(m, w, bsz), variant)
        # a NaN below the first pivot: every CTA's sums carry it, nothing hangs
        a = torch.from_numpy(testing.qr_edge_panel(1000, 33, "neg0", SEED + 5)).to(dt).cuda()
        a[700, 0] = float("nan")
        got, want = kernels.qr_panel(a), kernels.qr_panel_plain(a)
        torch.cuda.synchronize()
        check(bool(got[1][0].isnan()) and bool(want[1][0].isnan()),
              f"qr edges {dname(dt)}: a NaN column did not give the twin's NaN tau")
    emit({"phase": "kernel_qr_edges", "cases": cases, "worst_reading": worst,
          "seconds": time.perf_counter() - t0})


def qr_panel_input(m, w, dtype, seed, torch, zero_col=None):
    a = randn((m, w), dtype, seed, torch)
    if zero_col is not None:
        a[:, zero_col] = 0
    a[0, 0] = -0.0  # the first pivot: sign +1, beta = -anorm < 0
    return a


def kernel_qr_phase(dtype, kernels, torch):
    """qr_panel at the gels leaf shape (m, 64) and the mesh merge shape
    (2nb, nb), and qr_panel_offset at the mesh panel shape (mtl nb, nb) of
    the mesh gels (a batch of three with row0 at 0, a middle tile and the
    last tile, one with a zero column; then the path's batch of p panels),
    each against its twin by utils.testing.qr_panel_check: every part of
    the factor at its own scale, Q R = A and the compact-WY identity."""
    from slate_tpu_torch.utils import testing

    name = dname(dtype)
    m_gels = GELS_MN[name][0]
    mfl = m_gels // NB // P * NB
    rows = []
    out = {"phase": f"kernel_qr_{name}"}
    # qr_panel: the leaf and the merge of two upper-triangular R blocks
    leaf = qr_panel_input(m_gels, QR_LEAF_W, dtype, SEED + 91, torch, zero_col=17)
    merge = torch.cat([randn((NB, NB), dtype, SEED + 92, torch).triu(),
                       randn((NB, NB), dtype, SEED + 93, torch).triu()])
    for tag, a in (("leaf", leaf), ("merge", merge)):
        got = kernels.qr_panel(a)
        torch.cuda.synchronize()
        want = kernels.qr_panel_plain(a)
        c = testing.qr_panel_check(a, got, want, False)
        out[f"qr_panel_{tag}"] = {"shape": list(a.shape), **c}
        check(testing.qr_panel_ok(c), f"qr_panel {name} {tag}: {c}")
        check(float(got[0][0, 0]) < 0, f"qr_panel {name} {tag}: the -0.0 pivot read sign -1")
        if tag == "leaf":
            check(float(got[1][17]) == 0.0 and float(got[0][17, 17]) == 0.0,
                  f"qr_panel {name}: the zero column is not dead")
            check(qr_mutants_fail(a, got, want, False, 0, testing),
                  f"qr_panel {name}: a wrong factor passed")
    ms = cuda_ms(lambda: kernels.qr_panel(leaf), 10, torch)
    plain_ms = cuda_ms(lambda: kernels.qr_panel_plain(leaf), 2, torch)
    library_ms = cuda_ms(lambda: torch.geqrf(leaf), 10, torch)  # VR and tau, no T
    merge_ms = cuda_ms(lambda: kernels.qr_panel(merge), 10, torch)
    merge_plain_ms = cuda_ms(lambda: kernels.qr_panel_plain(merge), 2, torch)
    merge_library_ms = cuda_ms(lambda: torch.geqrf(merge), 10, torch)
    nbytes, flops = qr_bound(m_gels, QR_LEAF_W, 1, name, False)
    row = row_of("qr_panel", dtype, "slate_tpu_torch/csrc/qr_panel.cu",
                 "slate_tpu/ops/pallas_ops.py:632", out["qr_panel_leaf"]["max_abs_err"], ms,
                 plain_ms, library_ms, nbytes, flops)
    mbytes, mflops = qr_bound(2 * NB, NB, 1, name, False)
    out["qr_panel_timing"] = {
        "shape": [m_gels, QR_LEAF_W], "kernel_ms": ms, "plain_ms": plain_ms,
        "library_ms_geqrf_no_T": library_ms, "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "barrier_floor_ms": qr_barrier_floor(kernels, dtype, 1, m_gels, QR_LEAF_W),
        "merge_shape": [2 * NB, NB], "merge_kernel_ms": merge_ms, "merge_plain_ms": merge_plain_ms,
        "merge_library_ms_geqrf_no_T": merge_library_ms,
        "merge_bound_ms": max(mbytes / PEAK_BYTES_S, mflops / PEAK_FLOPS_S[name]) * 1e3,
        "merge_barrier_floor_ms": qr_barrier_floor(kernels, dtype, 1, 2 * NB, NB)}
    rows.append(row)
    # qr_panel_offset: row0 at 0, a middle tile, the last tile; a zero column
    r0s = [0, (mfl // NB // 2) * NB, mfl - NB]
    batch = torch.stack([qr_panel_input(mfl, NB, dtype, SEED + 94 + i, torch,
                                        zero_col=40 if i == 1 else None) for i in range(3)])
    ridx = torch.arange(mfl, device="cuda")
    for i, r0 in enumerate(r0s):
        batch[i, ridx < r0] = 0
        batch[i, r0, 0] = -0.0
    got = kernels.qr_panel_offset(batch, r0s)
    torch.cuda.synchronize()
    want = kernels.qr_panel_offset_plain(batch, r0s)
    errs = []
    for i, r0 in enumerate(r0s):
        gi, wi = tuple(x[i] for x in got), tuple(x[i] for x in want)
        c = testing.qr_panel_check(batch[i], gi, wi, True, r0)
        out[f"qr_panel_offset_row0_{r0}"] = c
        errs.append(c["max_abs_err"])
        check(testing.qr_panel_ok(c), f"qr_panel_offset {name} row0 {r0}: {c}")
        check(qr_mutants_fail(batch[i], gi, wi, True, r0, testing),
              f"qr_panel_offset {name} row0 {r0}: a wrong factor passed")
        check(bool((gi[0][:r0] == 0).all()) and bool((gi[1][:r0] == 0).all()),
              f"qr_panel_offset {name} row0 {r0}: rows above row0 were written")
        check(float(gi[0][r0, 0]) < 0, f"qr_panel_offset {name} row0 {r0}: the -0.0 pivot read -1")
    check(float(got[2][1, 40]) == 0.0 and float(got[1][1, r0s[1] + 40, 40]) == 0.0,
          f"qr_panel_offset {name}: the zero column is not dead (tau 0, v pivot 0)")
    path = torch.stack([qr_panel_input(mfl, NB, dtype, SEED + 97 + i, torch) for i in range(P)])
    path_r0 = [0] * P  # step 0: every mesh row's panel starts at its first slot
    ms = cuda_ms(lambda: kernels.qr_panel_offset(path, path_r0), 5, torch)
    plain_ms = cuda_ms(lambda: kernels.qr_panel_offset_plain(path, path_r0), 2, torch)
    library_ms = cuda_ms(lambda: torch.geqrf(path), 5, torch)  # batched VR and tau, no T
    nbytes, flops = qr_bound(mfl, NB, P, name, True)
    row = row_of("qr_panel_offset", dtype, "slate_tpu_torch/csrc/qr_panel.cu",
                 "slate_tpu/ops/pallas_ops.py:659", max(errs), ms, plain_ms, library_ms, nbytes,
                 flops)
    out["qr_panel_offset_timing"] = {"shape": [P, mfl, NB], "kernel_ms": ms, "plain_ms": plain_ms,
                                     "library_ms_geqrf_no_T": library_ms,
                                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                                     "barrier_floor_ms": qr_barrier_floor(kernels, dtype, P, mfl, NB)}
    rows.append(row)
    emit(out)
    del leaf, merge, batch, path, got, want
    torch.cuda.empty_cache()
    return rows


def geqrf_leaves(n, qr):
    """The leaves of linalg.qr._geqrf_rec for n columns: one qr_panel launch
    each on the card (derived from its split, not by hand)."""
    if n <= qr._QR_PANEL:
        return 1
    h = qr._split_qr(n)
    return geqrf_leaves(h, qr) + geqrf_leaves(n - h, qr)


def gels_residual(a, x, b):
    """tester.py's run_gels gate reading: |A^H (A X - B)| /
    (max|A|^2 max|X| m), in the working dtype (TF32 off)."""
    r = (a.T @ (a @ x - b)).abs().max()
    return float(r / (a.abs().max() ** 2 * x.abs().max() * a.shape[0]))


def gels_operands(m, n, dtype, torch):
    return randn((m, n), dtype, SEED + 101, torch), randn((m, NRHS), dtype, SEED + 102, torch)


def gels_phase(dtype, kernels, torch):
    """gels_array (MethodGels.QR) at m = 2n on one card, after a warm-up
    solve: the normal-equations gate of tester.py's run_gels and the
    componentwise one (utils.testing.gels_omega, in f64, gate 20 eps /
    sqrt(m)), the qr_panel launches (the leaves of _geqrf_rec), seconds,
    peak memory; then geqrf's Q R = A at n = 4096, and the same gels there
    with _geqrf_rec's products at TF32, which the componentwise gate must
    refuse."""
    from slate_tpu_torch.linalg import qr
    from slate_tpu_torch.ops.matmul import matmul
    from slate_tpu_torch.types import MethodGels, Op, Option, Precision, Side
    from slate_tpu_torch.utils import testing

    name = dname(dtype)
    m, n = GELS_MN[name]
    eps = torch.finfo(dtype).eps
    opts = {Option.MethodGels: MethodGels.QR}
    wm, wn = QR_WARMUP_MN
    aw, bw = gels_operands(wm, wn, dtype, torch)
    check(bool(torch.isfinite(qr.gels_array(aw, bw, opts)).all()), f"gels {name}: warm-up failed")
    del aw, bw
    a, b = gels_operands(m, n, dtype, torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    x = qr.gels_array(a, b, opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    repeats = []  # the same solve again: a first run's own cost shows against these
    for _ in range(GELS_REPEATS):
        t1 = time.perf_counter()
        qr.gels_array(a, b, opts)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t1)
    res, gate = gels_residual(a, x, b), 100 * n * eps
    om, om_gate = testing.gels_omega(a, x, b), testing.gels_omega_gate(m, dtype)
    want = {"qr_panel": geqrf_leaves(n, qr), "qr_panel_offset": 0}
    del a, b
    torch.cuda.empty_cache()
    # geqrf's Q R = A at n = 4096: Q applied to R by unmqr, within m eps max|A|
    rm, rn = QR_RECON_MN
    a4 = randn((rm, rn), dtype, SEED + 103, torch)
    f = qr.geqrf_array(a4)
    rfull = torch.zeros_like(a4)
    rfull[:rn] = f.vr[:rn].triu()
    qr_a = qr.unmqr_array(Side.Left, Op.NoTrans, f, rfull)
    recon = float((qr_a - a4).abs().max()) / (rm * eps * float(a4.abs().max()))
    del f, rfull, qr_a
    # the mutant: every product of linalg.qr (the trailing updates and T
    # merges of _geqrf_rec, unmqr) in f32 at TF32
    b4 = randn((rm, NRHS), dtype, SEED + 104, torch)
    om_sound = testing.gels_omega(a4, qr.gels_array(a4, b4, opts), b4)
    sound_matmul = qr.matmul
    qr.matmul = lambda p_, q_, **kw: matmul(p_.float(), q_.float(),
                                            precision=Precision.High).to(p_.dtype)
    try:
        om_tf32 = testing.gels_omega(a4, qr.gels_array(a4, b4, opts), b4)
    finally:
        qr.matmul = sound_matmul
    om_gate4 = testing.gels_omega_gate(rm, dtype)
    del a4, b4
    emit({"phase": f"gels_{name}", "m": m, "n": n, "nrhs": NRHS, "method": "QR",
          "normal_eq_residual": res, "gate": gate, "omega": om, "omega_gate": om_gate,
          "launches": counts, "expected_launches": want,
          "seconds": seconds, "seconds_repeats": repeats, "peak_mem_bytes": peak,
          "x_finite": bool(torch.isfinite(x).all()),
          "geqrf_qr_recon_ratio": recon, "geqrf_recon_shape": [rm, rn],
          "omega_at_recon_shape": om_sound, "omega_tf32_products": om_tf32,
          "omega_gate_at_recon_shape": om_gate4})
    check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()), f"gels {name}: bad solution")
    check(res < gate, f"gels {name}: normal-equations residual {res} >= {gate}")
    check(om < om_gate, f"gels {name}: componentwise residual {om} >= {om_gate}")
    check(recon <= 1, f"gels {name}: geqrf Q R - A at {recon} of m eps max|A|")
    check(om_sound < om_gate4 < om_tf32,
          f"gels {name}: the gate does not tell TF32 products ({om_tf32}) from sound ones "
          f"({om_sound}) at {om_gate4}")
    for k, v in want.items():
        check(counts[k] == v, f"gels {name}: {counts[k]} {k} launches, expected {v}")
    torch.cuda.empty_cache()
    return counts, x


def mesh_gels_phase(dtype, kernels, mp, x_single, torch):
    """gels_mesh on a virtual 2 x 4 mesh at the single-chip gels size,
    after a warm-up gels_mesh: seconds, the launches derived from the code,
    peak memory, info, the two gates and the agreement with the
    single-chip X.  Then its steps (from_dense -> geqrf_dist -> unmqr_dist
    -> the R round trip -> trsm_dist) inlined and timed one by one, their X
    held bitwise to gels_mesh's; then a zero column for the info code."""
    from slate_tpu_torch.parallel.dist_qr import _tree_rounds
    from slate_tpu_torch.types import Diag, Op, Uplo
    from slate_tpu_torch.utils import testing

    name = dname(dtype)
    m, n = GELS_MN[name]
    eps = torch.finfo(dtype).eps
    mesh = mp.make_mesh(P, Q, device="cuda")
    wm, wn = QR_WARMUP_MN
    aw, bw = gels_operands(wm, wn, dtype, torch)
    xw, infow = mp.gels_mesh(aw, bw, mesh, NB)
    check(int(infow) == 0 and bool(torch.isfinite(xw).all()), f"mesh gels {name}: warm-up failed")
    del aw, bw, xw
    a, b = gels_operands(m, n, dtype, torch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    x, info = mp.gels_mesh(a, b, mesh, NB)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    info = int(info)
    nt = mp.padded_tiles(n, NB, mesh)
    merges = sum(len(rnd) for rnd in _tree_rounds(P))
    want = {"qr_panel_offset": nt, "qr_panel": nt * merges}
    res, gate = gels_residual(a, x, b), 100 * n * eps
    om, om_gate = testing.gels_omega(a, x, b), testing.gels_omega_gate(m, dtype)
    # two backward-stable least-squares solvers on the same A, B: they
    # agree to the forward-error class (cond(A)^2 ~ 34 for a 2:1 Gaussian
    # A, times a random walk of m-term sums); a wrong X reads O(1)
    agree = float((x - x_single).abs().max() / x_single.abs().max())
    agree_gate = 100 * math.sqrt(n) * eps
    # the split: gels_mesh's steps inlined (the same calls and options)
    split = {}
    t = time.perf_counter()

    def mark(step):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        split[step] = now - t
        t = now

    ad, bd = mp.from_dense(a, mesh, NB), mp.from_dense(b, mesh, NB)
    mark("from_dense")
    f = mp.geqrf_dist(ad, overwrite_a=True)
    del ad
    mark("geqrf_dist")
    qb = mp.to_dense(mp.unmqr_dist(f, bd, Op.ConjTrans))[:n]
    mark("unmqr_dist")
    r = torch.triu(mp.to_dense(f.fact)[:n, :n])
    del f
    rd = mp.from_dense(r, mesh, NB, diag_pad_one=True)
    qd = mp.from_dense(qb, mesh, NB)
    mark("r_round_trip")
    x_split = mp.to_dense(mp.trsm_dist(rd, qd, Uplo.Upper, Op.NoTrans, Diag.NonUnit))
    mark("trsm_dist")
    split_equal = bool(torch.equal(x_split, x))
    del rd, qd, r, bd, x_split
    del a, b
    torch.cuda.empty_cache()
    # a zero column j: R(j, j) is exactly zero, info j + 1
    j = 2 * NB + 77
    az, bz = gels_operands(wm, wn, dtype, torch)
    az[:, j] = 0
    _, zinfo = mp.gels_mesh(az, bz, mesh, NB)
    del az, bz
    emit({"phase": f"mesh_gels_{name}", "m": m, "n": n, "nrhs": NRHS, "nb": NB, "grid": [P, Q],
          "info": info, "normal_eq_residual": res, "gate": gate, "omega": om,
          "omega_gate": om_gate, "x_vs_single_chip": agree, "x_vs_single_chip_gate": agree_gate,
          "launches": counts, "expected_launches": want, "solve_seconds": seconds,
          "split_seconds": split, "split_x_bitwise_equal": split_equal,
          "peak_mem_bytes": peak, "x_finite": bool(torch.isfinite(x).all()),
          "zero_column": j, "zero_column_info": int(zinfo), "expected_info": j + 1})
    check(info == 0, f"mesh gels {name}: info {info}")
    check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()), f"mesh gels {name}: bad X")
    check(res < gate, f"mesh gels {name}: normal-equations residual {res} >= {gate}")
    check(om < om_gate, f"mesh gels {name}: componentwise residual {om} >= {om_gate}")
    check(agree < agree_gate, f"mesh gels {name}: X differs from the single-chip X by {agree}")
    check(split_equal, f"mesh gels {name}: the inlined steps' X differs from gels_mesh's")
    check(int(zinfo) == j + 1, f"mesh gels {name}: zero column {j} gave info {int(zinfo)}")
    for k, v in want.items():
        check(counts[k] == v, f"mesh gels {name}: {counts[k]} {k} launches, expected {v}")
    del x
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the FT slice: the checksum-carrying SUMMA kernel and the ABFT mesh drivers
# ---------------------------------------------------------------------------

# gemm_ft at the mesh gemm's size; f64 at half, as the other f64 paths
FT_GEMM_N = {"float32": 16384, "float64": 8192}
FT_FACTOR_N = 16384
FT_WARMUP_N = 2048
FT_DOUBLE_N = 4096


def ft_shape(n):
    """(mt, kt, mtl, ntl) of gemm_ft at n: the data tile count, the
    k-steps, and the local stacks of the augmented grid (mt + 2 checksum
    tile rows / columns, padded to the mesh)."""
    mt = n // NB
    aug = -(-(mt + 2) // math.lcm(P, Q)) * math.lcm(P, Q)
    return mt, mt, aug // P, aug // Q


def kernel_ft_summa_phase(dtype, kernels, testing, local_indices, torch):
    """ft_summa_update against its twin at one step of the f32 n = 16384 (f64
    n = 8192) gemm_ft: acc (2, 4, mtl, ntl) tiles of 256, the stride-0 A
    column panel (2, 1, mtl) and B row panel (1, 4, ntl), the weights of the
    real augmented grid (zero on the checksum and pad rows).  acc holds to
    the tile-update limit, each part to it scaled by sum |w| plus the two
    orders of the I-row sum (utils.testing.ft_summa_check); a zeroed part,
    and in f32 a TF32 product, must each fail their reading."""
    name = dname(dtype)
    mt, _, mtl, ntl = ft_shape(FT_GEMM_N[name])
    acc = randn((P, Q, mtl, ntl, NB, NB), dtype, SEED + 91, torch, 10.0)
    pan = randn((P, 1, mtl, NB, NB), dtype, SEED + 92, torch)
    urow = randn((1, Q, ntl, NB, NB), dtype, SEED + 93, torch)
    part = randn((P, Q, 2, ntl, NB, NB), dtype, SEED + 94, torch, 100.0)
    _, _, i_log, _ = local_indices(P, Q, mtl, ntl, "cuda")
    data = i_log < mt
    w1, w2 = data.to(dtype), ((i_log + 1) * data).to(dtype)
    got = kernels.ft_summa_update(acc.clone(), pan, urow, w1, w2, part.clone())
    torch.cuda.synchronize()
    want = kernels.ft_summa_update_plain(acc.clone(), pan, urow, w1, w2, part.clone())
    readings = testing.ft_summa_check(acc, pan, urow, w1, w2, part, got, want)
    zeroed = testing.ft_summa_check(acc, pan, urow, w1, w2, part,
                                    (got[0], torch.zeros_like(got[1])), want)
    mutants = {"zeroed_part0": zeroed["part0"], "zeroed_part1": zeroed["part1"]}
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = kernels.ft_summa_update_plain(acc.clone(), pan, urow, w1, w2, part.clone())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        r = testing.ft_summa_check(acc, pan, urow, w1, w2, part, tf32, want)
        mutants.update({"tf32_acc": r["acc"], "tf32_part0": r["part0"], "tf32_part1": r["part1"]})
        del tf32
    err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    del got, want
    check(all(v <= 1 for v in readings.values()), f"ft_summa_update {name}: {readings}")
    check(all(v > 1 for v in mutants.values()), f"ft_summa_update {name}: a mutant passed {mutants}")
    a2, p2 = acc.clone(), part.clone()
    ms = cuda_ms(lambda: kernels.ft_summa_update(a2, pan, urow, w1, w2, p2), 5, torch)
    plain_ms = cuda_ms(lambda: kernels.ft_summa_update_plain(a2, pan, urow, w1, w2, p2), 2, torch)
    w1e, w2e = w1.expand(P, Q, mtl), w2.expand(P, Q, mtl)

    def library():
        upd = torch.matmul(pan.unsqueeze(-3), urow.unsqueeze(-4))
        torch.einsum("rqi,rqijab->rqjab", w1e, upd)
        torch.einsum("rqi,rqijab->rqjab", w2e, upd)

    library_ms = cuda_ms(library, 3, torch)
    tiles = P * Q * mtl * ntl
    isz = acc.element_size()
    # acc and part read and written once, the panels and weights read once
    nbytes = (2 * acc.numel() + 2 * part.numel() + pan.numel() + urow.numel()
              + 2 * P * mtl) * isz
    flops = tiles * (2 * NB ** 3 + 4 * NB * NB)  # the products, then 2 weighted adds each
    row = row_of("ft_summa_update", dtype, "slate_tpu_torch/csrc/ft_summa_update.cu",
                 "slate_tpu/ops/pallas_ops.py:819", err, ms, plain_ms, library_ms, nbytes, flops)
    emit({"phase": f"kernel_ft_summa_{name}", "grid": [P, Q, mtl, ntl], "nb": NB,
          "readings": readings, "mutant_readings": mutants, "max_abs_err": err,
          "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], **rate(flops, row)})
    del acc, part, a2, p2
    torch.cuda.empty_cache()
    return row


def timed(fn, torch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def floor_ratio(err, out, ops, scale_tiles, nb, cks):
    """How far an output error E = (faulty - clean) reaches toward
    slate_tpu's detection threshold, on the side whose carried checksums
    the fault cannot touch: the largest unit and ramp tile-column sums of
    E, each over its threshold, the thresholds taken as the reference
    takes them — 64 ops eps times scale_tiles (scale_tiles^2 for the ramp)
    times max|out| of the FAULTY output.  < 1: the reference's decision
    rule flags nothing from that side."""
    fmax = max(1.0, cks.finite_max(out))
    tol1 = cks.threshold(ops, out.dtype, scale_tiles * fmax)
    tol2 = cks.threshold(ops, out.dtype, scale_tiles * scale_tiles * fmax)
    d = cks.row_checksums(err, nb).abs()
    return max(float(d[:nb].max()) / tol1, float(d[nb:].max()) / tol2)


def fault_fields(f):
    return [f.k, f.phase, f.ti, f.tj, f.r, f.c, f.mode, f.value]


def mesh_gemm_ft_phase(dtype, kernels, mp, torch):
    """gemm_ft (virtual 2 x 4, nb = 256) at n = 16384 f32 / 8192 f64 against
    the plain gemm_mesh of the same operands: a clean Detect run (clean
    report, the online discrepancy and its threshold, one ft_summa_update
    launch per k-step, seconds and the overhead over gemm_mesh), gemm_mesh
    with FaultTolerance off bitwise equal to gemm_mesh, then the seeded
    trailing (21) and bcast (22) faults under Correct.  A detected fault
    must end corrected (trailing) or corrected / recomputed (bcast), its
    detections naming the injected tile row or column, the result within
    the plain gemm's gate.  slate_tpu's threshold is 64 ops eps mt max|C|
    (16 max|C| in f32 at n = 16384), so an f32 fault stays below it (the
    threshold grows with max|C| of the faulty output, so no f32 fault there
    is seen): its error's tile-column sums must read < 1 of the threshold
    (floor_ratio), the reference's own decision.  The f64 faults and the
    f32 seeded trailing fault at n = 2048 (0.25 max|C|) must be detected
    and corrected."""
    from slate_tpu_torch.ft import FaultPlan, FtPolicy, abft, checksum, fault_scope, inject
    from slate_tpu_torch.obs import REGISTRY
    from slate_tpu_torch.types import Option

    name = dname(dtype)
    n = FT_GEMM_N[name]
    mt, kt, _, _ = ft_shape(n)
    mesh = mp.make_mesh(P, Q, device="cuda")
    aw = randn((FT_WARMUP_N, FT_WARMUP_N), dtype, SEED + 100, torch)
    abft.gemm_ft(1.0, aw, aw, mesh, NB, policy=FtPolicy.Detect)  # handles, allocator, kernel loads
    del aw
    a = randn((n, n), dtype, SEED + 101, torch)
    b = randn((n, n), dtype, SEED + 102, torch)
    ref = torch.matmul(a, b)  # full precision (TF32 off)
    rmax = float(ref.abs().max())
    gate = 4 * math.sqrt(n) * torch.finfo(dtype).eps  # mesh_gemm_phase's gate

    def rel(c):
        return float((c - ref).abs().max()) / rmax

    plain, plain_s = timed(lambda: mp.gemm_mesh(1.0, a, b, mesh, NB), torch)
    off = mp.gemm_mesh(1.0, a, b, mesh, NB, opts={Option.FaultTolerance: "off"})
    off_bitwise = bool(torch.equal(off, plain))
    del off
    reset_counts(kernels)
    REGISTRY.reset()
    torch.cuda.reset_peak_memory_stats()
    (c, rep), ft_s = timed(lambda: abft.gemm_ft(1.0, a, b, mesh, NB, policy=FtPolicy.Detect), torch)
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    disc = REGISTRY.gauge_value("ft.online_disc", op="gemm")
    cmax = max(1.0, float(c.abs().max()))
    tol1 = checksum.threshold((kt + mt) * NB, dtype, mt * cmax)
    clean = {"report_clean": rep.clean, "online_disc": disc, "threshold": tol1,
             "threshold_over_max_abs_c": tol1 / cmax, "rel_err": rel(c), "rel_err_plain": rel(plain),
             "max_abs_diff_vs_gemm_mesh": float((c - plain).abs().max()),
             "bitwise_gemm_mesh": bool(torch.equal(c, plain)), "seconds": ft_s,
             "gemm_mesh_seconds": plain_s, "overhead": ft_s / plain_s, "peak_mem_bytes": peak}
    del c
    faults = {}
    plan = [("seeded_trailing", inject.seeded_fault(21, "gemm", kt, (P, Q), phase="trailing")),
            ("seeded_bcast", inject.seeded_fault(22, "gemm", kt, (P, Q), phase="bcast"))]
    for label, f in plan:
        with fault_scope(FaultPlan([f])):
            (c, rep), s = timed(lambda: abft.gemm_ft(1.0, a, b, mesh, NB, policy=FtPolicy.Correct),
                                torch)
        wheres = [tuple(d["where"]) for d in rep.detections]
        faults[label] = {"fault": fault_fields(f), "action": rep.action, "detections": wheres,
                         "rel_err": rel(c), "seconds": s,
                         "names_tile": any(f.ti in w or f.tj in w for w in wheres),
                         "floor_ratio": floor_ratio(c - plain, c, (kt + mt) * NB, mt, NB, checksum)}
        del c
    if dtype == torch.float32:
        # the f32 correction path where the reference's threshold (0.25
        # max|C| at n = 2048) sees the seeded fault
        m = FT_WARMUP_N
        a2 = randn((m, m), dtype, SEED + 103, torch)
        b2 = randn((m, m), dtype, SEED + 104, torch)
        ref2 = torch.matmul(a2, b2)
        f = inject.seeded_fault(21, "gemm", m // NB, (P, Q), phase="trailing")
        with fault_scope(FaultPlan([f])):
            c, rep = abft.gemm_ft(1.0, a2, b2, mesh, NB, policy=FtPolicy.Correct)
        wheres = [tuple(d["where"]) for d in rep.detections]
        faults[f"seeded_trailing_n{m}"] = {
            "fault": fault_fields(f), "action": rep.action, "detections": wheres,
            "rel_err": float((c - ref2).abs().max()) / float(ref2.abs().max()),
            "gate": 4 * math.sqrt(m) * torch.finfo(dtype).eps,
            "names_tile": any(f.ti in w or f.tj in w for w in wheres)}
        del a2, b2, ref2, c
    emit({"phase": f"mesh_gemm_ft_{name}", "n": n, "nb": NB, "grid": [P, Q], "kt": kt,
          "gate": gate, "clean": clean, "ft_off_bitwise": off_bitwise, "faults": faults,
          "launches": counts})
    check(off_bitwise, f"gemm_ft {name}: FaultTolerance off is not bitwise gemm_mesh")
    check(clean["report_clean"] and disc is not None and 0 <= disc < 1e-2 * tol1,
          f"gemm_ft {name}: clean run {clean}")
    check(clean["rel_err"] < gate and clean["rel_err_plain"] < gate, f"gemm_ft {name}: {clean}")
    check(counts["ft_summa_update"] == kt,
          f"gemm_ft {name}: {counts['ft_summa_update']} ft_summa_update launches, expected {kt}")
    for label, v in faults.items():
        if v["action"] == "clean":  # below the reference's threshold: its decision too
            check(v["floor_ratio"] < 1, f"gemm_ft {name} {label}: undetected at floor ratio {v}")
            continue
        ok = v["action"] == "corrected" or ("bcast" in label and v["action"] == "recomputed")
        check(ok and v["names_tile"] and v["rel_err"] < v.get("gate", gate),
              f"gemm_ft {name} {label}: {v}")
    # f64 (threshold ~1e-8 max|C|) and f32 at n = 2048 (0.25 max|C|) see
    # their seeded faults; f32 at n = 16384 (16 max|C|) does not
    seen = [k for k in faults if dtype == torch.float64 or k.endswith(f"_n{FT_WARMUP_N}")]
    check(all(faults[k]["action"] != "clean" for k in seen), f"gemm_ft {name}: {faults}")
    del a, b, ref, plain
    torch.cuda.empty_cache()
    return counts


def factor_ratio(a, fac, form, n, torch):
    """The factor against A in f64: L L^T (potrf) or L U (LU).  Returns
    (normwise, elementwise): max|F1 F2 - A| / (n eps n max|F1| max|F2|),
    the backward-error bound gamma_n |F1||F2| <= (n u) n max|F1| max|F2|
    with room 2 (<= 1 passes), and the elementwise reading over
    3 n eps |F1||F2| (reported: a repaired tile carries the rounding of
    its column's checksum, the scale of the whole column, so its small
    entries can sit above their own elementwise bound; the repair itself
    is held by repair_limit)."""
    eps = torch.finfo(a.dtype).eps
    f64 = fac.double()
    if form == "potrf":
        f1 = f64.tril()
        del f64
        f2 = f1.T
    else:
        f1, f2 = f64.tril(-1), f64.triu()
        del f64
        f1.diagonal().fill_(1)
    res = (f1 @ f2 - a.double()).abs().max()
    norm = float(res) / (n * eps * n * float(f1.abs().max()) * float(f2.abs().max()))
    return norm, residual_ratio(f1, f2, a.double(), n, eps, torch)


def repair_limit(nt, dtype, fmax, torch):
    """How far a repaired factor may lie from the clean run's factor: a few
    ulps of its column checksum's scale, 4 mt eps mt max|F| (mt = nt data
    tile rows).  The repair is the carried checksum minus the recomputed
    tile sums, exact up to that rounding; the limit sits far below the
    detection threshold (64 n eps mt max|F|)."""
    return 4 * nt * nt * torch.finfo(dtype).eps * fmax


def misrepair_diff(dense, clean, f, corrupt):
    """max|mutant - clean| for a mutant whose repair block at the fault's
    tile is scaled by 1 + 1e-6 (off by 1e-6 of the fault it undoes); the
    rest of the factor is the repaired one."""
    blk = (slice(f.ti * NB, (f.ti + 1) * NB), slice(f.tj * NB, (f.tj + 1) * NB))
    tile = dense[blk]
    faulty = tile.clone()
    corrupt(faulty, f.mode, f.value)
    mutant = tile + 1e-6 * (tile - faulty)
    return max(float((dense - clean).abs().max()), float((mutant - clean[blk]).abs().max()))


def expected_ft_launches(form, nt, la):
    """Launches of one unfaulted factor run: the full-view loop (one
    bucket).  potrf: nt chol_panel_tiles, the updates torch.matmul; LU:
    nt panels and rows, and 3 nt - 2 lu_trailing_update at lookahead 1."""
    if form == "potrf":
        return {"chol_panel_tiles": nt, "chol_trailing_update": 0}
    return {"lu_panel_tiles": nt, "lu_rowsolve_tiles": nt,
            "lu_trailing_update": (3 * nt - 2) if la >= 1 else nt}


def mesh_factor_ft_phase(form, dtype, kernels, mp, torch):
    """potrf_ft / getrf_nopiv_ft at n = 16384 (virtual 2 x 4, nb = 256): a
    clean run, then under Correct the seeded panel-store fault (12) and
    the launches of that run derived from the loop; in f64 also a
    panel-store flip of 10 thresholds, and for the f64 potrf the seeded
    trailing fault (14).  slate_tpu's threshold is 64 N eps mt max|F|,
    max|F| the largest entry of the packed factor (U's diagonal, ~n, for
    the LU): 8 max|F| in f32 (it grows with the fault, so no f32 fault is
    seen there), ~1.5e-8 max|F| in f64.  A detected fault must end
    corrected (panel) / recomputed (trailing) with info 0, the factor equal
    to A by reconstruction in f64 (factor_ratio's normwise bound) and a
    corrected factor within repair_limit of the clean run's, where a
    mis-repaired tile (misrepair_diff, for a zeroed or scaled tile, whose
    repair block is the tile itself) must fail that limit.  A panel fault
    the reference's rule does not flag (final data: its discrepancy is its
    own tile sums) must read floor_ratio < 1."""
    from slate_tpu_torch.ft import Fault, FaultPlan, FtPolicy, abft, checksum, fault_scope, inject

    name = dname(dtype)
    n = FT_FACTOR_N
    nt = n // NB
    mesh = mp.make_mesh(P, Q, device="cuda")
    op = "potrf" if form == "potrf" else "getrf_nopiv"
    run = abft.potrf_ft if form == "potrf" else abft.getrf_nopiv_ft
    make = (lambda m, s: dominant_spd(m, dtype, s, torch)) if form == "potrf" else \
        (lambda m, s: lu_matrix("nopiv", m, dtype, s, torch))
    aw = make(FT_WARMUP_N, SEED + 110)
    run(aw, mesh, NB, policy=FtPolicy.Detect)  # handles, allocator, kernel loads
    del aw
    a = make(n, SEED + 111)
    out = {"phase": f"mesh_{op}_ft_{name}", "n": n, "nb": NB, "grid": [P, Q]}
    (fac, info, rep), s = timed(lambda: run(a, mesh, NB, policy=FtPolicy.Detect), torch)
    clean = mp.to_dense(fac)
    del fac
    fmax = max(1.0, float(clean.abs().max()))
    tol1 = checksum.threshold(n, dtype, nt * fmax)
    limit = repair_limit(nt, dtype, fmax, torch)
    out["clean"] = {"action": rep.action, "info": int(info), "seconds": s, "threshold": tol1,
                    "threshold_over_max_abs_factor": tol1 / fmax, "repair_limit": limit}
    lside = (lambda x: x.tril()) if form == "potrf" else (lambda x: x.tril(-1))
    k = nt - 4
    flip = Fault(op, k=k, phase="panel", ti=nt - 2, tj=k, r=(nt - 2) % P, c=k % Q,
                 mode=inject.MODE_FLIP, value=10 * tol1)
    # (label, fault, the action a detection must end in, must it be detected)
    cases = [("panel", inject.seeded_fault(12, op, nt, (P, Q), phase="panel"), "corrected", False)]
    if dtype == torch.float64:
        cases.append(("flip_10x_threshold", flip, "corrected", True))
    if form == "potrf" and dtype == torch.float64:
        # live-data damage: its discrepancy is not E's tile sums (no
        # floor_ratio), so only where the threshold sees it
        cases.append(("trailing", inject.seeded_fault(14, op, nt, (P, Q), phase="trailing"),
                      "recomputed", True))
    want = expected_ft_launches(form, nt, 1)
    for label, f, expect, must_see in cases:
        reset_counts(kernels)
        with fault_scope(FaultPlan([f])):
            (fac, info, rep), s = timed(lambda: run(a, mesh, NB, policy=FtPolicy.Correct), torch)
        counts = read_counts(kernels)
        dense = mp.to_dense(fac)
        del fac
        res = {"fault": fault_fields(f), "action": rep.action, "info": int(info),
               "detections": [tuple(d["where"]) for d in rep.detections], "seconds": s,
               "launches": counts}
        if rep.action == "clean":
            res["floor_ratio"] = floor_ratio(lside(dense) - lside(clean), dense, n, nt, NB,
                                             checksum)
        else:
            res["reconstruction_ratio"], res["elementwise_ratio"] = factor_ratio(a, dense, form, n,
                                                                                 torch)
            res["diff_vs_clean_over_limit"] = float((dense - clean).abs().max()) / limit
            if rep.action == "corrected" and f.mode != inject.MODE_FLIP:
                res["misrepair_over_limit"] = misrepair_diff(dense, clean, f, abft._corrupt) / limit
        del dense
        out[f"{label}_fault"] = res
        if label == "panel":
            out["expected_launches"] = want
            if rep.action != "recomputed":  # one run: the launches of one factor
                for key, v in want.items():
                    check(counts[key] == v, f"{op}_ft {name}: {counts[key]} {key} launches, "
                                            f"expected {v}")
        if rep.action == "clean":  # below the reference's threshold: its decision too
            check(not must_see and res["floor_ratio"] < 1 and int(info) == 0,
                  f"{op}_ft {name} {label}: undetected {res}")
        else:
            check(rep.action == expect and int(info) == 0 and res["reconstruction_ratio"] <= 1
                  and res["diff_vs_clean_over_limit"] <= 1
                  and res.get("misrepair_over_limit", 2) > 1, f"{op}_ft {name} {label}: {res}")
    emit(out)
    check(out["clean"]["action"] == "clean" and out["clean"]["info"] == 0,
          f"{op}_ft {name}: {out['clean']}")
    check(form != "potrf" or dtype != torch.float64
          or "misrepair_over_limit" in out["panel_fault"],
          f"{op}_ft {name}: the seeded panel fault was not repaired, so no mis-repair was held")
    del a, clean
    torch.cuda.empty_cache()
    return out


def ft_drivers_phase(mp, torch):
    """Option.FaultTolerance through the mesh drivers, f32 at n = 16384:
    posv_mesh (eta gate, info 0) and gesv_nopiv_mesh (eta and omega gates,
    info 0) under ``correct``; a persistent double fault (two trailing
    tiles scaled by 3 on every run) in the f64 LU at n = 4096 raises
    FtError."""
    from slate_tpu_torch.ft import Fault, FaultPlan, FtError, fault_scope
    from slate_tpu_torch.types import Option

    dtype = torch.float32
    n = FT_FACTOR_N
    mesh = mp.make_mesh(P, Q, device="cuda")
    opts = {Option.FaultTolerance: "correct"}
    b = randn((n, NRHS), dtype, SEED + 121, torch)
    gate = 100 * n * torch.finfo(dtype).eps
    out = {"phase": "ft_drivers", "n": n, "nrhs": NRHS}
    a = dominant_spd(n, dtype, SEED + 120, torch)
    (x, info), s = timed(lambda: mp.posv_mesh(a, b, mesh, NB, opts=opts), torch)
    out["posv_mesh"] = {"info": int(info), "eta": eta(a, x, b, torch), "eta_gate": gate,
                        "seconds": s}
    del a, x
    torch.cuda.empty_cache()
    a = lu_matrix("nopiv", n, dtype, SEED + 122, torch)
    (x, info), s = timed(lambda: mp.gesv_nopiv_mesh(a, b, mesh, NB, opts=opts), torch)
    out["gesv_nopiv_mesh"] = {"info": int(info), "eta": eta(a, x, b, torch), "eta_gate": gate,
                              "omega": omega(a, x, b, torch),
                              "omega_gate": omega_gate(n, dtype, torch), "seconds": s}
    del a, x
    torch.cuda.empty_cache()
    # in f64: the f32 threshold at this size sits above these mild faults
    nd = FT_DOUBLE_N
    a = lu_matrix("nopiv", nd, torch.float64, SEED + 123, torch)
    faults = [Fault("getrf_nopiv", k=1, phase="trailing", ti=4, tj=5, r=4 % P, c=5 % Q, mode=2,
                    value=3.0, persist=True),
              Fault("getrf_nopiv", k=2, phase="trailing", ti=6, tj=4, r=6 % P, c=4 % Q, mode=2,
                    value=3.0, persist=True)]
    try:
        with fault_scope(FaultPlan(faults)):
            mp.getrf_nopiv_mesh(a, mesh, NB, opts=opts)
        out["double_fault"] = {"n": nd, "raised": False}
    except FtError as e:
        out["double_fault"] = {"n": nd, "raised": True, "reason": e.reason,
                               "detections": len(e.detections)}
    emit(out)
    for k in ("posv_mesh", "gesv_nopiv_mesh"):
        check(out[k]["info"] == 0 and out[k]["eta"] < gate, f"ft drivers {k}: {out[k]}")
    check(out["gesv_nopiv_mesh"]["omega"] < out["gesv_nopiv_mesh"]["omega_gate"],
          f"ft drivers gesv_nopiv_mesh: {out['gesv_nopiv_mesh']}")
    check(out["double_fault"]["raised"], f"ft drivers: persistent double fault gave no FtError")
    del a, b
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# slice 4a: the three tile kernels, ops.transpose, the single-chip LU family
# and mixed-precision refinement
# ---------------------------------------------------------------------------

# the nb = 256 tile stack of an n = 32768 matrix: 4,294,967,296 B in f32
TILE_SHAPE = (16384, 256, 256)
TILE_SMALL = (9, 100, 300)  # mb != nb, ragged against the 32 x 32 tiles, a NaN tile
TILE_BITS = {"float32": "int32", "bfloat16": "int16"}
TILE_ALPHA, TILE_BETA = 0.3, -1.7
# gesv_array: f32 takes the recursive form at every size; f64 on the card
# the scanned form above 8192 and the left-looking one from 4096 to 8192
GESV_CASES = (("float32", 32768, "_getrf_rec"), ("float64", 16384, "getrf_scan_array"),
              ("float64", 8192, "_getrf_left_looking"))
METHODS_N = 8192
MIXED_N = 16384
GMRES_N = 4096
GETRI_N = 4096


def tile_stacks(shape, dtype, seed, torch):
    a = randn(shape, torch.float32, seed, torch).to(dtype)
    b = randn(shape, torch.float32, seed + 1, torch).to(dtype)
    return a, b


def geadd_excess(g, gp, a, b, dtype, torch, chunk=1024):
    """max over entries of |g - gp| / (eps (|alpha a| + |beta b|)), alpha
    and beta rounded to the dtype, in f64 over chunks of tiles; with the
    largest |g - gp|.  <= 1 passes."""
    al, be = (float(torch.tensor(x, dtype=dtype)) for x in (TILE_ALPHA, TILE_BETA))
    eps = torch.finfo(dtype).eps
    worst = err = 0.0
    for k0 in range(0, a.shape[0], chunk):
        sl = slice(k0, k0 + chunk)
        scale = (al * a[sl].double()).abs() + (be * b[sl].double()).abs()
        diff = (g[sl].double() - gp[sl].double()).abs()
        ok = torch.isfinite(scale)
        worst = max(worst, float((diff[ok] / (eps * scale[ok])).nan_to_num(0.0).max()))
        err = max(err, float(diff[ok].max()))
        check(torch.equal(torch.isnan(g[sl]), torch.isnan(gp[sl])), "geadd_tiles: NaN pattern")
    return worst, err


def tile_checks(kernels, testing, a, b, dtype, torch):
    """The three kernels against their twins on one stack: (transpose equal
    as words, genorm_max equal as words where not NaN and NaN at the same
    tiles, geadd excess, max abs errs), the launches of each call, the
    transpose's path (the host rule's and the source's own) and the max's
    split (the host's, which the launch takes)."""
    counted = ("transpose_tiles", "genorm_max_tiles", "geadd_tiles")
    before = [getattr(kernels, w).launches for w in counted]
    t, tp = kernels.transpose_tiles(a), kernels.transpose_tiles_plain(a)
    same_t = testing.tile_bits_equal(t, tp)
    rule = {"transpose": kernels.tile_path("transpose", a.shape, a.element_size(), a.data_ptr(),
                                           t.data_ptr()),
            "genorm_max": kernels.tile_path("genorm_max", a.shape, a.element_size(),
                                            a.data_ptr())}
    paths = {"transpose": [rule["transpose"].name, kernels.transpose_path_on_card(a, t)]}
    del t, tp
    n, np_ = kernels.genorm_max_tiles(a), kernels.genorm_max_tiles_plain(a)
    same_n = testing.tile_max_equal(n, np_)
    nan_tiles = int(torch.isnan(n).sum())
    g = kernels.geadd_tiles(TILE_ALPHA, a, TILE_BETA, b)
    gp = kernels.geadd_tiles_plain(TILE_ALPHA, a, TILE_BETA, b)
    torch.cuda.synchronize()
    launches = [getattr(kernels, w).launches - x for w, x in zip(counted, before)]
    excess, err = geadd_excess(g, gp, a, b, dtype, torch)
    return {"transpose_bitwise": same_t, "genorm_max_bitwise": same_n, "nan_tiles": nan_tiles,
            "geadd_excess": excess, "geadd_max_abs_err": err, "launches": launches,
            "paths": paths, "max_split": rule["genorm_max"].name,
            "ragged": [rule["transpose"].ragged, rule["genorm_max"].ragged]}


# (label, shape, offset in words): the stacks that reach every path of the
# transpose (vec16 whole and masked, scalar) and the max (a CTA or a warp a
# tile, tiles peeled or not); the special-value stacks of
# utils.testing.tile_special_stack the same way
TILE_EDGES = (("aligned_ragged", (10, 136, 264), 0),
              ("misaligned_view", (8, 100, 37), 3700),  # a[1:] of (9, 100, 37)
              ("offset_view", (9, 64, 136), 1),
              ("k_over_65535_scalar", (70000, 2, 128), 0),
              ("k_over_65535_vec16", (66000, 8, 128), 0))
TILE_SPECIAL = (("special_vec16_cta", (12, 64, 136), 0),
                ("special_scalar_peeled", (12, 37, 129), 1),
                ("special_vec16_warp", (12, 8, 128), 0))


def tile_edges_phase(dtype, kernels, testing, torch):
    """TILE_EDGES and TILE_SPECIAL against the twins: one launch a kernel,
    transpose and genorm_max bitwise, geadd within its excess, the host's
    path the source's."""
    name = dname(dtype)
    out = {}
    for label, shape, offset in TILE_EDGES + TILE_SPECIAL:
        if label.startswith("special"):
            a = testing.tile_special_stack(shape, dtype, offset, seed=SEED + 95)
        else:  # made on the card: k > 65535 stacks hold 18-68 M words
            n = math.prod(shape)
            a = randn((offset + n,), torch.float32, SEED + 94, torch).to(dtype)[offset:]
            a = a.view(shape)
            a[1, 0, 2] = float("nan")
        b = randn(shape, torch.float32, SEED + 96, torch).to(dtype)
        c = tile_checks(kernels, testing, a, b, dtype, torch)
        c.update(shape=list(shape), offset_words=offset, base_mod16=a.data_ptr() % 16)
        out[label] = c
        del a, b
    emit({"phase": f"kernel_tile_edges_{name}", "cases": out})
    for label, c in out.items():
        check(c["transpose_bitwise"] and c["genorm_max_bitwise"],
              f"tile kernels {name} {label}: not the twins' words")
        check(c["geadd_excess"] <= 1.0, f"geadd_tiles {name} {label}: {c['geadd_excess']}")
        check(c["launches"] == [1, 1, 1], f"tile kernels {name} {label}: {c['launches']} launches")
        for kern, (host, card) in c["paths"].items():
            check(host == card, f"{kern} {name} {label}: host rule {host}, source {card}")
        want_nan = 3 if label.startswith("special") else 1
        check(c["nan_tiles"] == want_nan, f"genorm_max_tiles {name} {label}: {c['nan_tiles']} NaN")
    torch.cuda.empty_cache()


# (label, tile bytes, k): the max's splits timed against each other; the
# sweep's stacks hold 256 MiB (5x the L2), "tiny" is launch-bound, "full" is
# TILE_SHAPE
TILE_SPLIT_MIB = 256
TILE_SPLIT_BYTES = (512, 2048, 8192, 16384, 32768, 131072)


def tile_max_split_phase(dtype, kernels, testing, torch):
    """genorm_max_tiles' two work splits (a CTA a tile, a warp a tile),
    each launched directly (not counted), timed by CUDA events and checked
    bitwise against the twin, over tile sizes at a fixed stack size, a
    12-tile stack and the full stack: the readings behind
    kernels.TILE_MAX_CTA_BYTES."""
    name = dname(dtype)
    s = torch.tensor([], dtype=dtype).element_size()
    nb = 128
    cases = [(f"tile_{t}B", (TILE_SPLIT_MIB * 2 ** 20 // t, t // (nb * s), nb))
             for t in TILE_SPLIT_BYTES if t >= nb * s]
    cases += [("tiny", (12, 8, 128)), ("full", TILE_SHAPE)]
    codes = kernels._TILE_PATH_CODES["genorm_max"]
    out = {}
    for label, shape in cases:
        a = randn(shape, torch.float32, SEED + 97, torch).to(dtype)
        a[shape[0] // 2, 0, 1] = float("nan")
        want = kernels.genorm_max_tiles_plain(a)
        row = {"shape": list(shape), "tile_bytes": shape[1] * shape[2] * s,
               "rule": kernels.tile_path("genorm_max", shape, s, a.data_ptr()).name}
        for split in codes:
            got = torch.empty((shape[0],), dtype=dtype, device="cuda")

            def launch():
                kernels._launch_tiles("genorm_max_tiles", "genorm_max", dtype, a.device,
                                      a.data_ptr(), got.data_ptr(), shape[0], shape[1] * shape[2],
                                      codes.index(split))

            row[f"{split}_ms"] = cuda_ms(launch, 10, torch)
            row[f"{split}_bitwise"] = testing.tile_max_equal(got, want)
        row["faster"] = min(codes, key=lambda c: row[f"{c}_ms"])
        out[label] = row
        del a, want, got
        torch.cuda.empty_cache()
    emit({"phase": f"kernel_tile_max_split_{name}", "cases": out})
    for label, row in out.items():
        for split in codes:
            check(row[f"{split}_bitwise"], f"genorm_max {split} split {name} {label}: not the twin")


def kernel_tile_phase(dtype, kernels, testing, torch):
    """The tile kernels against their twins at the (16384, 256, 256) stack
    and a small mb != nb stack with a NaN tile; kernel, twin and library ms
    (CUDA events, L2 warm: the stack is 43-86x the L2) and the bound, and a
    copy of the stack (``clone``) as the card's copy rate in this run.
    geadd_tiles and genorm_max_tiles have no consumer on a driver path (as
    in slate_tpu): their launches are those of this phase's timed calls."""
    name = dname(dtype)
    small_a, small_b = tile_stacks(TILE_SMALL, dtype, SEED + 92, torch)
    small_a[4, 7, 11] = float("nan")
    small = tile_checks(kernels, testing, small_a, small_b, dtype, torch)
    a, b = tile_stacks(TILE_SHAPE, dtype, SEED + 90, torch)
    big = tile_checks(kernels, testing, a, b, dtype, torch)
    k, mb, nb = TILE_SHAPE
    s = a.element_size()
    elems = k * mb * nb
    specs = {  # kernel, twin, library, bytes (inputs read once, output written once), ops
        "transpose_tiles": (lambda: kernels.transpose_tiles(a),
                            lambda: kernels.transpose_tiles_plain(a),
                            lambda: a.transpose(-1, -2).contiguous(), 2 * elems * s, 0,
                            ":89", "transpose_bitwise"),
        "geadd_tiles": (lambda: kernels.geadd_tiles(TILE_ALPHA, a, TILE_BETA, b),
                        lambda: kernels.geadd_tiles_plain(TILE_ALPHA, a, TILE_BETA, b),
                        lambda: torch.add(TILE_BETA * b, a, alpha=TILE_ALPHA), 3 * elems * s,
                        3 * elems, ":107", None),
        "genorm_max_tiles": (lambda: kernels.genorm_max_tiles(a),
                             lambda: kernels.genorm_max_tiles_plain(a),
                             lambda: a.abs().amax(dim=(-2, -1)), elems * s + k * s, elems,
                             ":139", "genorm_max_bitwise"),
    }
    rows, times = [], {}
    for kname, (kern, plain, lib, nbytes, ops, line, bitwise_key) in specs.items():
        ms = cuda_ms(kern, 10, torch)
        plain_ms = cuda_ms(plain, 3, torch)
        library_ms = cuda_ms(lib, 10, torch)
        kernels_obj = getattr(kernels, kname)
        kernels_obj.launches = 0
        kern()
        torch.cuda.synchronize()
        timed_launches = kernels_obj.launches
        if bitwise_key:
            err = 0.0 if small[bitwise_key] and big[bitwise_key] else float("inf")
        else:
            err = max(small["geadd_max_abs_err"], big["geadd_max_abs_err"])
        row = row_of(kname, dtype, "slate_tpu_torch/csrc/tile_ops.cu",
                     f"slate_tpu/ops/pallas_ops.py{line}", err, ms, plain_ms, library_ms,
                     nbytes, ops)
        row["launches"] = timed_launches
        rows.append(row)
        times[kname] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "share_of_bound": row["bound_ms"] / ms}
    # the card's copy rate in this run: a copy moves the transpose's bytes
    copy_ms = cuda_ms(lambda: a.clone(), 10, torch)
    copy = {"ms": copy_ms, "bytes": 2 * elems * s, "TB_s": 2 * elems * s / copy_ms / 1e9}
    emit({"phase": f"kernel_tile_{name}", "shape": list(TILE_SHAPE), "small": small, "big": big,
          "times": times, "copy": copy})
    for part in (small, big):
        check(part["transpose_bitwise"], f"transpose_tiles {name}: not the twin's bits")
        check(part["genorm_max_bitwise"], f"genorm_max_tiles {name}: not the twin's maxima")
        check(part["geadd_excess"] <= 1.0, f"geadd_tiles {name}: {part['geadd_excess']} eps scale")
        check(part["launches"] == [1, 1, 1], f"tile kernels {name}: {part['launches']} launches")
        for kern, (host, card) in part["paths"].items():
            check(host == card, f"{kern} {name}: host rule {host}, source {card}")
    check(small["nan_tiles"] == 1, f"genorm_max_tiles {name}: {small['nan_tiles']} NaN tiles")
    del a, b
    torch.cuda.empty_cache()
    return rows


def tile_transpose_phase(dtype, kernels, torch):
    """slate_tpu_torch.ops.transpose on the (16384, 256, 256) stack: one
    transpose_tiles launch, the result bitwise the swapped axes; a stack
    below the gate (k = 4) launches nothing.  Returns the launches."""
    from slate_tpu_torch import ops

    name = dname(dtype)
    bits = getattr(torch, TILE_BITS[name])
    a = randn(TILE_SHAPE, torch.float32, SEED + 93, torch).to(dtype)
    torch.cuda.synchronize()
    reset_counts(kernels)
    out = ops.transpose(a)
    torch.cuda.synchronize()
    launches = kernels.transpose_tiles.launches
    same = bool(torch.equal(out.view(bits), a.transpose(-1, -2).contiguous().view(bits)))
    below = ops.transpose(a[:4])
    launches_below = kernels.transpose_tiles.launches - launches
    same_below = bool(torch.equal(below, a[:4].transpose(-1, -2)))
    emit({"phase": f"tile_transpose_{name}", "shape": list(TILE_SHAPE), "launches": launches,
          "bitwise": same, "below_gate_launches": launches_below, "below_gate_equal": same_below})
    check(launches == 1 and same, f"ops.transpose {name}: {launches} launches, bitwise {same}")
    check(launches_below == 0 and same_below, f"ops.transpose {name}: k = 4 launched")
    del a, out, below
    torch.cuda.empty_cache()
    return launches


def _first_form(lu, fn):
    """fn() with getrf_array's three forms recorded; returns (fn's result,
    the first form called)."""
    names = ("_getrf_rec", "_getrf_left_looking", "getrf_scan_array")
    orig = {k: getattr(lu, k) for k in names}
    calls = []

    def wrap(k):
        def inner(*args, **kw):
            calls.append(k)
            return orig[k](*args, **kw)
        return inner

    try:
        for k in names:
            setattr(lu, k, wrap(k))
        out = fn()
    finally:
        for k, v in orig.items():
            setattr(lu, k, v)
    return out, (calls[0] if calls else None)


def lu_solve_gates(a, x, b, info, who, torch):
    n = a.shape[0]
    dtype = a.dtype
    e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
    w, w_gate = omega(a, x, b, torch), omega_gate(n, dtype, torch)
    check(int(info) == 0, f"{who}: info {int(info)}")
    check(tuple(x.shape) == tuple(b.shape) and bool(torch.isfinite(x).all()),
          f"{who}: bad solution")
    check(e < gate, f"{who}: eta {e} >= {gate}")
    check(w < w_gate, f"{who}: omega {w} >= {w_gate}")
    return {"info": int(info), "eta": e, "eta_gate": gate, "omega": w, "omega_gate": w_gate}


def timed_solve(fn, torch):
    """(fn()'s result, seconds, peak bytes), the clock and the peak around
    fn alone."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def gesv_phase(torch):
    """gesv_array (partial pivoting) on uniform[-1, 1) with 32 right-hand
    sides: f32 at n = 32768 and the two f64 forms on the card, each after a
    warm-up solve at n = 2048; info, eta, omega (f64 residual), seconds,
    peak memory and the form getrf_array took.  Returns the f64 n = 16384
    seconds (the full solve the mixed phase compares with)."""
    from slate_tpu_torch.linalg import lu

    out = {}
    for name, n, form in GESV_CASES:
        dtype = getattr(torch, name)
        aw = lu_matrix("pp", WARMUP_N, dtype, SEED + 100, torch)
        xw, fw = lu.gesv_array(aw, aw[:, :NRHS].clone())
        check(int(fw.info) == 0 and bool(torch.isfinite(xw).all()), f"gesv {name}: warm-up failed")
        del aw, xw, fw
        a = lu_matrix("pp", n, dtype, SEED + 101 + n, torch)
        b = randn((n, NRHS), dtype, SEED + 102 + n, torch)
        ((x, f), took), seconds, peak = timed_solve(
            lambda: _first_form(lu, lambda: lu.gesv_array(a, b)), torch)
        info = f.info
        del f
        res = {"n": n, "form": took, "seconds": seconds, "peak_mem_bytes": peak,
               **lu_solve_gates(a, x, b, info, f"gesv {name} n = {n}", torch)}
        out[f"{name}_{n}"] = res
        check(took == form, f"gesv {name} n = {n}: getrf_array took {took}, expected {form}")
        del a, b, x
        torch.cuda.empty_cache()
    emit({"phase": "gesv", "nrhs": NRHS, **out})
    return out[f"float64_{MIXED_N}"]["seconds"]


def gesv_methods_phase(torch):
    """gesv_array with MethodLU.NoPiv (on uniform[-1, 1) + n I) and CALU (on
    uniform[-1, 1)), f32 at n = 8192: the same gates and seconds."""
    from slate_tpu_torch.linalg import lu
    from slate_tpu_torch.types import MethodLU

    out = {}
    n = METHODS_N
    for method, form in ((MethodLU.NoPiv, "nopiv"), (MethodLU.CALU, "pp")):
        a = lu_matrix(form, n, torch.float32, SEED + 110, torch)
        b = randn((n, NRHS), torch.float32, SEED + 111, torch)
        wa = lu_matrix(form, WARMUP_N, torch.float32, SEED + 112, torch)
        lu.gesv_array(wa, wa[:, :NRHS].clone(), method)
        del wa
        (x, f), seconds, peak = timed_solve(lambda: lu.gesv_array(a, b, method), torch)
        out[method.name] = {"seconds": seconds, "peak_mem_bytes": peak,
                            **lu_solve_gates(a, x, b, f.info, f"gesv {method.name}", torch)}
        del a, b, x, f
        torch.cuda.empty_cache()
    emit({"phase": "gesv_methods", "n": n, "nrhs": NRHS, "dtype": "float32", **out})


def mixed_phase(full_gesv_seconds, torch):
    """gesv_mixed_array and posv_mixed_array f64 at n = 16384, 32
    right-hand sides (the f32 factor refined to the f64 gate), against the
    full f64 solve of the same matrix (gesv: the gesv phase's scanned solve
    of this matrix; posv: posv_array timed here); gesv_mixed_gmres_array at
    n = 4096.  Iterations, converged, info, eta at the f64 level, and
    ||b - A x||_inf <= ||x||_inf gate_cte (the classic refinement's own
    gate); GMRES's residual norm under its tolerance."""
    from slate_tpu_torch.linalg import chol, refine
    from slate_tpu_torch.ops.tile_ops import genorm
    from slate_tpu_torch.types import Norm

    def gate_ok(a, x, b):
        cte = refine.gate_cte(genorm(Norm.Inf, a), a.shape[0], a.dtype)
        return bool(genorm(Norm.Inf, b - a @ x) <= genorm(Norm.Inf, x) * cte)

    out = {}
    n = MIXED_N
    f64 = torch.float64
    a = lu_matrix("pp", n, f64, SEED + 101 + n, torch)  # the gesv phase's f64 matrix
    b = randn((n, NRHS), f64, SEED + 102 + n, torch)
    wa = lu_matrix("pp", WARMUP_N, f64, SEED + 120, torch)
    refine.gesv_mixed_array(wa, wa[:, :NRHS].clone())
    del wa
    r, seconds, peak = timed_solve(lambda: refine.gesv_mixed_array(a, b), torch)
    out["gesv_mixed"] = {"n": n, "iters": int(r.iters), "converged": bool(r.converged),
                         "info": int(r.info), "eta": eta(a, r.x, b, torch),
                         "eta_gate": 100 * n * torch.finfo(f64).eps,
                         "gate_cte_ok": gate_ok(a, r.x, b),
                         "seconds": seconds, "full_f64_seconds": full_gesv_seconds,
                         "peak_mem_bytes": peak}
    del a, b, r
    torch.cuda.empty_cache()
    a = dominant_spd(n, f64, SEED + 121, torch)
    b = randn((n, NRHS), f64, SEED + 122, torch)
    wa = dominant_spd(WARMUP_N, f64, SEED + 123, torch)
    refine.posv_mixed_array(wa, wa[:, :NRHS].clone())
    chol.posv_array(wa, wa[:, :NRHS].clone())
    del wa
    r, seconds, peak = timed_solve(lambda: refine.posv_mixed_array(a, b), torch)
    (xf, _, infof), full_seconds, _ = timed_solve(lambda: chol.posv_array(a, b), torch)
    out["posv_mixed"] = {"n": n, "iters": int(r.iters), "converged": bool(r.converged),
                         "info": int(r.info), "eta": eta(a, r.x, b, torch),
                         "eta_gate": 100 * n * torch.finfo(f64).eps,
                         "gate_cte_ok": gate_ok(a, r.x, b),
                         "seconds": seconds, "full_f64_seconds": full_seconds,
                         "full_f64_info": int(infof), "peak_mem_bytes": peak}
    del a, b, r, xf
    torch.cuda.empty_cache()
    # GMRES-IR on uniform[-1, 1) + n I: its preconditioned residual can
    # reach the tolerance sqrt(n) eps ||b_j|| (on uniform[-1, 1) alone it
    # stalls above it and runs all 30 restarts)
    n = GMRES_N
    a = lu_matrix("nopiv", n, f64, SEED + 124, torch)
    b = randn((n, NRHS), f64, SEED + 125, torch)
    refine.gesv_mixed_gmres_array(a[:256, :256].contiguous(), b[:256])
    (x, rnorm), seconds, peak = timed_solve(lambda: refine.gesv_mixed_gmres_array(a, b), torch)
    tol = math.sqrt(n) * torch.finfo(f64).eps * float(torch.linalg.vector_norm(b, dim=0).max())
    # (GMRES stops on the preconditioned residual, so gate_cte's gate on
    # b - A x is the classic loop's, not its own)
    out["gesv_mixed_gmres"] = {"n": n, "rnorm": float(rnorm), "rnorm_tol": tol,
                               "eta": eta(a, x, b, torch),
                               "eta_gate": 100 * n * torch.finfo(f64).eps, "seconds": seconds,
                               "peak_mem_bytes": peak}
    del a, b, x
    torch.cuda.empty_cache()
    emit({"phase": "mixed", "nrhs": NRHS, **out})
    for k in ("gesv_mixed", "posv_mixed"):
        res = out[k]
        check(res["converged"] and res["iters"] >= 0 and res["info"] == 0,
              f"{k}: iters {res['iters']}, converged {res['converged']}, info {res['info']}")
    for k, res in out.items():
        check(res["eta"] < res["eta_gate"] and res.get("gate_cte_ok", True), f"{k}: {res}")
    g = out["gesv_mixed_gmres"]
    check(g["rnorm"] <= g["rnorm_tol"], f"gesv_mixed_gmres: rnorm {g['rnorm']} > {g['rnorm_tol']}")


def lu_misc_phase(torch):
    """getri_array f64 at n = 4096 (||A X - I|| against n eps ||A|| ||X||),
    gecondest against the exact 1 / kappa_1 of a small matrix, and a zero
    column j giving info j + 1 in the f32 recursive and f64 left-looking
    forms."""
    import numpy as np

    from slate_tpu_torch.linalg import lu, norms
    from slate_tpu_torch.types import Norm
    from slate_tpu_torch.utils.testing import generate

    out = {"phase": "lu_misc"}
    n = GETRI_N
    a = lu_matrix("pp", n, torch.float64, SEED + 130, torch)
    f = lu.getrf_array(a)
    xinv = lu.getri_array(f)
    resid = float((a @ xinv - torch.eye(n, dtype=a.dtype, device="cuda")).abs().max())
    limit = n * torch.finfo(a.dtype).eps * float(a.abs().max()) * float(xinv.abs().max()) * n
    out["getri"] = {"n": n, "info": int(f.info), "resid": resid, "limit": limit}
    del a, f, xinv
    small = torch.from_numpy(generate("svd", 256, dtype=np.float64, seed=131, cond=1e6)).cuda()
    anorm = float(small.abs().sum(dim=0).max())
    exact = 1.0 / (anorm * float(torch.linalg.inv(small).abs().sum(dim=0).max()))
    est = float(norms.gecondest(Norm.One, lu.getrf_array(small), anorm))
    out["gecondest"] = {"n": 256, "estimate": est, "exact": exact, "ratio": est / exact}
    zero = {}
    for dtype, j in ((torch.float32, n // 4 + 17), (torch.float64, 3 * n // 4 - 5)):
        z = lu_matrix("pp", n, dtype, SEED + 132, torch)
        z[:, j] = 0
        zero[dname(dtype)] = {"column": j, "info": int(lu.getrf_array(z).info)}
        del z
    out["zero_column"] = zero
    torch.cuda.empty_cache()
    emit(out)
    g = out["getri"]
    check(g["info"] == 0 and g["resid"] < g["limit"], f"getri: {g}")
    c = out["gecondest"]
    check(1.0 - 1e-9 <= c["ratio"] <= 3.0, f"gecondest: {c}")
    for name, z in zero.items():
        check(z["info"] == z["column"] + 1, f"zero column {name}: {z}")


# ---------------------------------------------------------------------------
# slice 8a: the blocked GEMM, the Ozaki int8 scheme and the f64 mesh ladder
# ---------------------------------------------------------------------------

# the H100's dense tensor-core bf16 peak (the bound of the bf16 product)
PEAK_BF16_TC = 989e12
# (name, m, k, n, dtype): 8192^3 in f32, bf16 and f16, the factorizations'
# thin-k rank update (matmul.py:131-133) in f32 and bf16, one ragged f32 shape
MATMUL_CASES = (("8192^3", 8192, 8192, 8192, "float32"), ("8192^3", 8192, 8192, 8192, "bfloat16"),
                ("8192^3", 8192, 8192, 8192, "float16"),
                ("thin_k", 32768, 256, 32768, "float32"), ("thin_k", 32768, 256, 32768, "bfloat16"),
                ("ragged", 1000, 777, 1234, "float32"))
OZAKI_SMALL, OZAKI_N = 512, 8192
MIXED_POSV_N, MIXED_GESV_N, MIXED_ESC_N, MIXED_FT_N = 16384, 8192, 2048, 8192
MIXED_WARMUP_N = 1024
# The refined gesv's omega limit, in units of omega_gate (10 sqrt(n) eps).
# Refinement stops at a normwise gate, so omega lands wherever its last step
# leaves the worst row: over 13 seeds at n = 8192 the sound runs read
# 0.014-2.47 of omega_gate (tools/ladder_omega_report.py on an H100; PERF.md,
# PR 8).  Planted unit-L^-1 faults that refinement absorbs read 0.02-0.27
# (their X is as good; only the iterations show them), and a dropped slab
# leaves X NaN under IR alone: no fault reads between 2.47 and this limit.
GESV_LADDER_OMEGA = 3.0
# the refined gesv's extra seeds, each held to the same limit
GESV_LADDER_SEEDS = (170, 172, 174)


def kernel_matmul_phase(kernels, testing, torch):
    """matmul_pallas against its twin (utils.testing.matmul_pallas_excess:
    9 sqrt(k) eps32 |A||B| elementwise, Higham and Mary's probabilistic
    bound, plus one output ulp in bf16/f16) at the MATMUL_CASES shapes, with
    kernel, twin and library times (CUDA events, L2 warm; library =
    torch.matmul in the same dtype, TF32 off) and the bound (2mnk at the
    tensor cores' 989 TFLOP/s, six times that for f32's six bf16 plane
    products; bytes at 3.35 TB/s where larger; the f32 FFMA bound at 67
    TFLOP/s beside it).  Each operand's path is kernels.matmul_operand_plan's
    (in place K-major, in place MN-major for a row-major B, or packed);
    a packed operand's pack is timed on its own (kernels.matmul_pack) and
    given as a share of the call.  Peak memory is read over one call, above
    what the operands held before it.  The limit must sit between the sound
    reading and a planted fault: the kernel's C with 8 k indices dropped
    reads above 1.  A second call must give the same bits (no atomics).  The
    f32 form is also held to the six plane products it sums
    (utils.testing.matmul_split6_reading, which the elementwise limit cannot
    do: it passes a C with a plane pair dropped, and a TF32 product): within
    MATMUL_SPLIT6_LIMIT, and its C with any one second-order plane pair
    dropped must read above it.  At 8192^3 each side's max error from the
    f64 product is read too (and, for f32, a TF32 product's), in units of
    eps32 max(|A||B|), and the kernel's must stay within a fixed limit on
    its ratio to the twin's.  Each case's
    launches are those of one call of the public ops.matmul_pallas (no
    driver reaches the kernel, as in slate_tpu); the kernels line takes the
    8192^3 calls'.  Returns the f32, bf16 and f16 rows."""
    from slate_tpu_torch import ops
    from slate_tpu_torch.ops.matmul import pallas_blocks

    out, rows = {}, {}
    eps32 = torch.finfo(torch.float32).eps
    for case, m, k, n, name in MATMUL_CASES:
        dtype = getattr(torch, name)
        a = randn((m, k), torch.float32, SEED + 140 + m + k, torch).to(dtype)
        b = randn((k, n), torch.float32, SEED + 141 + n, torch).to(dtype)
        blocks = pallas_blocks(m, k, n)  # slate_tpu's clamp: the twin pads to them
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.matmul_pallas.launches = 0
        c = ops.matmul_pallas(a, b)
        torch.cuda.synchronize()
        launches = kernels.matmul_pallas.launches
        peak = torch.cuda.max_memory_allocated() - held
        again = ops.matmul_pallas(a, b)
        bitwise = bool(torch.equal(c, again))
        del again
        want = kernels.matmul_pallas_plain(a, b, *blocks)
        excess = testing.matmul_pallas_excess(a, b, c, want)
        err = float((c.double() - want.double()).abs().max())
        s0 = (k // 2) // 8 * 8  # 8 k indices from the middle
        dropped = (c.float() - a[:, s0:s0 + 8].float() @ b[s0:s0 + 8].float()).to(dtype)
        fault = testing.matmul_pallas_excess(a, b, dropped, want)
        del dropped
        res = {"m": m, "k": k, "n": n, "launches": launches, "bitwise_repeat": bitwise,
               "excess": excess, "dropped_slab_excess": fault, "max_abs_err": err,
               "peak_bytes_over_operands": peak}
        if name == "float32":
            split6, split6_faults = testing.matmul_split6_reading(a, b, c)
            res.update(split6_reading=split6, split6_dropped_pair=split6_faults,
                       split6_limit=testing.MATMUL_SPLIT6_LIMIT)
        if case == "8192^3":
            exact = a.double() @ b.double()
            scale = eps32 * float((a.double().abs() @ b.double().abs()).max())
            f64_err = {"kernel": float((c.double() - exact).abs().max()) / scale,
                       "twin": float((want.double() - exact).abs().max()) / scale}
            res["err_vs_f64_eps32_absab"] = f64_err
            # a loose limit: twice the ratio of the worst-case bounds of a
            # k-long chain (k u) and of the twin's bk-deep blocks summed in
            # a k / bk chain ((bk + k / bk) u).  The kernel's 64-deep slabs,
            # summed in a k / 64 chain, sit well inside it; the split6
            # reading above is what guards the f32 form's plane products.
            res["f64_err_ratio_limit"] = 2 * k / (blocks[2] + k / blocks[2])
            check(f64_err["kernel"] <= res["f64_err_ratio_limit"] * f64_err["twin"],
                  f"matmul_pallas {case} {name}: error from the f64 product {f64_err}")
            if name == "float32":
                torch.backends.cuda.matmul.allow_tf32 = True
                tf32 = torch.matmul(a, b)
                torch.backends.cuda.matmul.allow_tf32 = False
                res["err_vs_f64_eps32_absab"]["tf32_product"] = (
                    float((tf32.double() - exact).abs().max()) / scale)
                res["tf32_product_excess"] = testing.matmul_pallas_excess(a, b, tf32, want)
                res["tf32_product_split6_reading"] = testing.matmul_split6_reading(a, b, tf32)[0]
                del tf32
            del exact
        del c, want
        torch.cuda.empty_cache()
        reps = 3 if m * n * k > 1 << 33 else 10
        ms = cuda_ms(lambda: kernels.matmul_pallas(a, b, *blocks), reps, torch)
        plain_ms = cuda_ms(lambda: kernels.matmul_pallas_plain(a, b, *blocks), reps, torch)
        library_ms = cuda_ms(lambda: torch.matmul(a, b), reps, torch)
        paths, pack_ms = {}, 0.0
        for t, which in ((a, "a"), (b, "b")):
            plan = kernels.matmul_operand_plan(which, t.shape, t.stride(), t.data_ptr(),
                                               t.element_size())
            paths[which] = ("packed" if not plan.in_place else "in_place" if plan.k_major
                            else "in_place_mn")
            if not plan.in_place:
                pack_ms += cuda_ms(lambda: kernels.matmul_pack(t, which), reps, torch)
        s = a.element_size()
        flops = 2 * m * n * k
        passes = 6 if name == "float32" else 1
        nbytes = (m * k + k * n + m * n) * s
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = passes * flops / PEAK_BF16_TC * 1e3
        res.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations", tflops=flops / ms / 1e9,
                   paths=paths, pack_ms=pack_ms, pack_share=pack_ms / ms)
        if name == "float32":
            res["bound_ffma_ms"] = max(t_bytes, flops / PEAK_FLOPS_S["float32"] * 1e3)
        out[f"{case}_{name}"] = res
        check(launches == 1, f"matmul_pallas {case} {name}: {launches} launches")
        check(bitwise, f"matmul_pallas {case} {name}: a second call gave other bits")
        check(excess <= 1.0, f"matmul_pallas {case} {name}: {excess} of the tolerance")
        check(fault > 1.0, f"matmul_pallas {case} {name}: the tolerance passes a dropped k-slab "
                           f"({fault})")
        if name == "float32":
            check(split6 <= testing.MATMUL_SPLIT6_LIMIT,
                  f"matmul_pallas {case} {name}: {split6} from its six plane products")
            check(min(split6_faults.values()) > testing.MATMUL_SPLIT6_LIMIT,
                  f"matmul_pallas {case} {name}: the split6 limit passes a dropped plane pair "
                  f"{split6_faults}")
        if case == "8192^3":
            rows[name] = {"name": f"matmul_pallas[{name}]", "route": "cuda",
                          "source": "slate_tpu_torch/csrc/matmul.cu",
                          "replaces": "slate_tpu/ops/matmul.py:73", "launches": launches,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
                          "library_ms": library_ms}
        del a, b
        torch.cuda.empty_cache()
    emit({"phase": "kernel_matmul", **out})
    return list(rows.values())


def ozaki_phase(mp, torch):
    """ops.ozaki on the card: matmul_f64 and matmul_c128 at 512 bitwise the
    same functions' CPU result; at 8192 the time and the max relative error
    against torch.matmul in f64 (cuBLAS DGEMM on the FP64 tensor cores), and
    the time of both; gemm_summa_ozaki at n = 8192 on 2 x 4 against the f64
    gemm_summa (GemmC), times and the audited bytes (9/8)."""
    import numpy as np

    from slate_tpu_torch.ops import ozaki
    from slate_tpu_torch.parallel.comm import comm_audit
    from slate_tpu_torch.parallel.summa import gemm_summa_ozaki
    from slate_tpu_torch.types import MethodGemm

    out = {"phase": "ozaki"}
    rng = np.random.default_rng(SEED + 150)
    a = torch.from_numpy(rng.standard_normal((OZAKI_SMALL, OZAKI_SMALL)))
    b = torch.from_numpy(rng.standard_normal((OZAKI_SMALL, OZAKI_SMALL)))
    a[3] = 0
    a[5] *= 1e-30
    same = {}
    for s in (9, 6):
        same[f"f64_s{s}"] = bool(torch.equal(ozaki.matmul_f64(a.cuda(), b.cuda(), s).cpu(),
                                             ozaki.matmul_f64(a, b, s)))
    ac, bc = torch.complex(a, b), torch.complex(b, -a)
    same["c128"] = bool(torch.equal(ozaki.matmul_c128(ac.cuda(), bc.cuda()).cpu(),
                                    ozaki.matmul_c128(ac, bc)))
    out["bitwise_cpu_512"] = same
    n = OZAKI_N
    a = randn((n, n), torch.float64, SEED + 151, torch)
    b = randn((n, n), torch.float64, SEED + 152, torch)
    ref = torch.matmul(a, b)
    c = ozaki.matmul_f64(a, b)
    rel = float((c - ref).abs().max() / ref.abs().max())
    del c
    out["matmul_f64_8192"] = {"ozaki_ms": cuda_ms(lambda: ozaki.matmul_f64(a, b), 2, torch),
                              "dgemm_ms": cuda_ms(lambda: torch.matmul(a, b), 5, torch),
                              "max_rel_err": rel}
    del ref
    mesh = mp.make_mesh(P, Q, device="cuda")
    ad, bd = mp.from_dense(a, mesh, NB), mp.from_dense(b, mesh, NB)
    del a, b
    torch.cuda.empty_cache()
    with comm_audit() as recs_oz:
        oz = gemm_summa_ozaki(1.0, ad, bd)
    with comm_audit() as recs_64:
        f64 = mp.gemm_summa(1.0, ad, bd, method=MethodGemm.GemmC)
    bytes_oz = sum(nb_ * m for _, nb_, m in recs_oz)
    bytes_64 = sum(nb_ * m for _, nb_, m in recs_64)
    rel_mesh = float((oz.tiles - f64.tiles).abs().max() / f64.tiles.abs().max())
    del oz, f64
    torch.cuda.empty_cache()
    _, oz_s = timed(lambda: gemm_summa_ozaki(1.0, ad, bd), torch)
    _, f64_s = timed(lambda: mp.gemm_summa(1.0, ad, bd, method=MethodGemm.GemmC), torch)
    out["gemm_summa_ozaki_8192"] = {"grid": [P, Q], "nb": NB, "ozaki_seconds": oz_s,
                                    "f64_seconds": f64_s, "audited_bytes_ozaki": bytes_oz,
                                    "audited_bytes_f64": bytes_64,
                                    "bytes_ratio": bytes_oz / bytes_64,
                                    "max_rel_diff_vs_f64": rel_mesh}
    del ad, bd
    torch.cuda.empty_cache()
    emit(out)
    check(all(same.values()), f"ozaki on the card is not the CPU's bits: {same}")
    check(rel < 1e-13, f"matmul_f64 8192: relative error {rel}")
    check(bytes_oz * 8 == bytes_64 * 9, f"gemm_summa_ozaki audited {bytes_oz} vs f64 {bytes_64}")
    check(rel_mesh < 1e-12, f"gemm_summa_ozaki 8192: {rel_mesh} from the f64 SUMMA")


def _ir_deltas(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _tier(d):
    if d.get("fallback"):
        return "fallback"
    if d.get("escalated_gmres") or d.get("gmres_solves"):
        return "gmres"
    return "ir" if d.get("solves") else "direct"


CAPTURE_BYTES = 64 << 20


class Capture:
    """Stands in for a kernel wrapper in the module that calls it, for one
    driver run: counts the calls by dtype and hands each on to the wrapper,
    and keeps the inputs of the widest call whose first operand has
    ``dtype`` (the most elements in that operand; the first of equals):
    each its shape and strides, with its values up to CAPTURE_BYTES (a
    larger one, refilled from a seed later, leaves the run's memory as it
    was)."""

    def __init__(self, module, name, dtype):
        self.module, self.name, self.dtype = module, name, dtype
        self.wrapper = getattr(module, name)
        self.args, self.width, self.calls = None, 0, {}

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.wrapper)

    def __call__(self, *args):
        key = dname(args[0].dtype)
        self.calls[key] = self.calls.get(key, 0) + 1
        if args[0].dtype == self.dtype and args[0].numel() > self.width:
            self.width = args[0].numel()
            self.args = [(tuple(x.shape), x.stride(), x.dtype,
                          x.clone() if x.numel() * x.element_size() <= CAPTURE_BYTES else None)
                         for x in args]
        return self.wrapper(*args)

    def inputs(self, seed, torch, scale=1.0):
        """The kept inputs at the run's shapes and strides; a large one
        filled from ``seed``."""
        out = []
        for i, (shape, stride, dtype, value) in enumerate(self.args):
            if any(st == 0 and sz > 1 for st, sz in zip(stride, shape)):
                stride = torch.empty(shape, device="meta").stride()  # a broadcast: dense
            x = torch.empty_strided(shape, stride, dtype=dtype, device="cuda")
            x.copy_(value if value is not None else randn(shape, dtype, seed + i, torch, scale))
            out.append(x)
        return out


def ladder_kernels_phase(kernels, caps, summa_launches, torch):
    """The kernels of the f64 ladder held against their twins at the inputs
    the ladder gave them (Capture: the widest call in the measured posv_mesh
    n = 16384 auto run and gesv_mesh n = 8192 auto run; a large operand --
    the trailing view, the SUMMA accumulator -- at its shape and strides,
    refilled from a seed).  summa_update in f64 (the residual SUMMA: A's
    column panel against the 32-rhs X row panel) gets its kernels-line row,
    with the posv run's launches; chol_panel_tiles, chol_trailing_update and
    lu_rowsolve_tiles in f32 (the f32 factors) are held at these shapes too,
    their rows staying with phases 8 and 12."""
    f64, f32 = torch.float64, torch.float32
    out = {"phase": "ladder_kernels"}
    cap = caps["summa_update"]
    check(cap.args is not None, "ladder: no f64 summa_update call captured")
    check(set(cap.calls) == {"float64"} and cap.calls["float64"] == summa_launches,
          f"ladder: summa_update calls {cap.calls}, launches {summa_launches}")
    acc, acol, brow = cap.inputs(SEED + 170, torch)
    mask = torch.ones(acc.shape[:4], dtype=torch.bool, device="cuda")
    calls = update_calls("summa_update", kernels, acol, brow, mask, torch)
    err, tol, _ = hold_update("summa_update", "float64", acc, acol, brow, mask, calls[0],
                              calls[1], torch)
    row, live = update_row("summa_update", f64, acc, acol, brow, mask, err, torch, calls)
    row["launches"] = summa_launches
    out["summa_update_float64"] = {"acc": list(acc.shape), "acol": list(acol.shape),
                                   "brow": list(brow.shape), "tiles": live, "err": err, "tol": tol,
                                   "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
                                   "library_ms": row["library_ms"], "bound_ms": row["bound_ms"],
                                   "launches": summa_launches,
                                   **rate(2 * acc.shape[-1] ** 3 * live, row)}
    del acc, acol, brow
    cap = caps["chol_panel_tiles"]
    check(cap.args is not None, "ladder: no f32 chol_panel_tiles call captured")
    dtile, pcol = cap.inputs(SEED + 173, torch)
    fac, err_s, tol_s, _ = hold_chol_panel("float32 (ladder)", dtile, pcol, kernels, torch)
    out["chol_panel_tiles_float32"] = {"tiles": list(pcol.shape), "err_solved": err_s,
                                       "tol_solved": tol_s, "err_L": fac["err_L"],
                                       "tol_L": fac["tol_L"]}
    del dtile, pcol
    cap = caps["chol_trailing_update"]
    check(cap.args is not None, "ladder: no f32 chol_trailing_update call captured")
    view, pan, pan_t, mask = cap.inputs(SEED + 175, torch)
    calls = update_calls("chol_trailing_update", kernels, pan, pan_t, mask, torch)
    err, tol, untouched = hold_update("chol_trailing_update", "float32 (ladder)", view, pan, pan_t,
                                      mask, calls[0], calls[1], torch)
    out["chol_trailing_update_float32"] = {"view": list(view.shape), "tiles": int(mask.sum()),
                                           "err": err, "tol": tol, "masked_untouched": untouched}
    del view, pan, pan_t, mask
    cap = caps["lu_rowsolve_tiles"]
    check(cap.args is not None, "ladder: no f32 lu_rowsolve_tiles call captured")
    luk, prow = cap.inputs(SEED + 179, torch)
    err_r, tol_r, _ = hold_lu_rowsolve("float32 (ladder)", luk, prow, kernels, torch)
    out["lu_rowsolve_tiles_float32"] = {"tiles": list(prow.shape), "err_solved": err_r,
                                        "tol_solved": tol_r}
    del luk, prow
    torch.cuda.empty_cache()
    emit(out)
    return row


LADDER_COUNTED = ("chol_panel_tiles", "chol_trailing_update", "summa_update", "lu_rowsolve_tiles")


def ladder_run(kind, a, b, mesh, mp, kernels, torch, opts=None, caps=()):
    """posv_mesh or gesv_mesh on (a, b) under ``opts``, the ``caps`` in
    place: info, the tier taken, iters, the ir.* deltas, seconds, peak
    memory, the kernel launches, eta and omega (f64 residual) with their
    gates, and the refinement's own gate ||r|| <= ||x|| ||A|| eps sqrt(n)."""
    from slate_tpu_torch.linalg import refine
    from slate_tpu_torch.obs import REGISTRY
    from slate_tpu_torch.utils.testing import refine_gate_ok

    drv = mp.posv_mesh if kind == "posv" else mp.gesv_mesh
    ir0 = refine.ir_counter_values()
    with ExitStack() as stack:
        for c in caps:
            stack.enter_context(c)
        reset_counts(kernels)
        (x, info), seconds, peak = timed_solve(lambda: drv(a, b, mesh, NB, opts=opts), torch)
        launches = {k: getattr(kernels, k).launches for k in LADDER_COUNTED}
    d = _ir_deltas(ir0, refine.ir_counter_values())
    n = a.shape[0]
    eps = torch.finfo(torch.float64).eps
    res = {"n": n, "nrhs": b.shape[1], "info": int(info), "tier": _tier(d), "ir_deltas": d,
           "iters": REGISTRY.gauge_value("ir.iters", op=kind) if d.get("solves") else None,
           "seconds": seconds, "peak_mem_bytes": peak, "launches": launches,
           "eta": eta(a, x, b, torch), "eta_gate": 100 * n * eps,
           "omega": omega(a, x, b, torch), "omega_gate": omega_gate(n, torch.float64, torch),
           "refine_gate_ok": refine_gate_ok(a, x, b),
           "x_finite": bool(torch.isfinite(x).all())}
    del x
    return res


def ladder_faults(r, omega_limit):
    """The gates a refined ladder solve fails ([] if none): info 0 and a
    finite X, eta < 100 n eps, omega < omega_limit, the IR tier with its
    iterations, and the refinement's own normwise gate."""
    return [name for name, ok in (
        ("info", r["info"] == 0 and r["x_finite"]), ("eta", r["eta"] < r["eta_gate"]),
        ("omega", r["omega"] < omega_limit), ("tier", r["tier"] == "ir" and r["iters"] is not None),
        ("refine_gate", r["refine_gate_ok"])) if not ok]


@contextmanager
def planted_unit_linv_fault(kernels, scale):
    """A planted fault in the diagonal block's unit-L^-1 (the unit_linv
    entry's output, before lu_rowsolve_tiles' tile product): rows 64 on of
    its second 32-wide block column times ``scale`` (0 drops that slab)."""
    launch = kernels._launch_lu

    def faulty(entry, who, src, *outs):
        launch(entry, who, src, *outs)
        if entry == "unit_linv":
            outs[0][64:, 32:64] *= scale

    kernels._launch_lu = faulty
    try:
        yield
    finally:
        kernels._launch_lu = launch


def ir_alone():
    """The ladder pinned to IR with no fallback: a planted fault's run stops
    there (GMRES-IR on a broken preconditioner, one column at a time, runs
    for minutes at n = 8192)."""
    from slate_tpu_torch.types import Option

    return {Option.MixedPrecision: "ir", Option.UseFallbackSolver: False}


def gesv_ladder_case(seed, n, mesh, mp, kernels, torch, caps=(), opts=None):
    """The refined gesv (auto, or ``opts``) at n on the pp matrix and rhs of
    ``seed``."""
    f64 = torch.float64
    a = lu_matrix("pp", n, f64, SEED + seed, torch)
    b = randn((n, NRHS), f64, SEED + seed + 1, torch)
    r = ladder_run("gesv", a, b, mesh, mp, kernels, torch, opts=opts, caps=caps)
    del a, b
    torch.cuda.empty_cache()
    return r


def mixed_mesh_phase(kernels, mp, torch):
    """The f64 mesh ladder (virtual 2 x 4, nb = 256, 32 rhs), each after a
    warm-up at n = 1024: posv_mesh at n = 16384 under auto (ResidualImpl
    f64), auto with ozaki, and off; gesv_mesh at n = 8192 under auto (on
    four seeds, and with a dropped unit-L^-1 slab under IR alone) and off; an
    ill-conditioned gesv at n = 2048 (cond 1e12, one rhs) that escalates;
    posv_mesh under FaultTolerance at n = 8192 (ladder_run's readings for
    each).  eta is held to 100 n eps and omega to 10 sqrt(n) eps, the
    refined gesv's omega to GESV_LADDER_OMEGA times that; the refined solves
    also to the IR tier and the refinement's own gate, and the planted
    fault must fail one of them.  The posv and gesv auto runs keep their
    kernels' widest inputs (Capture) for ladder_kernels_phase, whose
    summa_update[float64] row it returns."""
    import numpy as np

    from slate_tpu_torch.parallel import dist_chol, dist_lu, summa
    from slate_tpu_torch.types import Option

    mesh = mp.make_mesh(P, Q, device="cuda")
    f64 = torch.float64

    def run(kind, a, b, opts=None, caps=()):
        return ladder_run(kind, a, b, mesh, mp, kernels, torch, opts=opts, caps=caps)

    out = {"phase": "mixed_mesh", "grid": [P, Q], "nb": NB}
    # warm-ups: handles, allocator, kernel loads, every tier's code path
    wa = dominant_spd(MIXED_WARMUP_N, f64, SEED + 160, torch)
    wb = randn((MIXED_WARMUP_N, NRHS), f64, SEED + 161, torch)
    for opts in (None, {Option.ResidualImpl: "ozaki"}, {Option.MixedPrecision: "off"}):
        mp.posv_mesh(wa, wb, mesh, NB, opts=opts)
    wg = lu_matrix("pp", MIXED_WARMUP_N, f64, SEED + 162, torch)
    for opts in (None, {Option.MixedPrecision: "off"}):
        mp.gesv_mesh(wg, wb, mesh, NB, opts=opts)
    del wa, wb, wg
    n = MIXED_POSV_N
    a = dominant_spd(n, f64, SEED + 163, torch)
    b = randn((n, NRHS), f64, SEED + 164, torch)
    caps = {"summa_update": Capture(summa, "summa_update", f64),
            "chol_panel_tiles": Capture(dist_chol, "chol_panel_tiles", torch.float32),
            "chol_trailing_update": Capture(dist_chol, "chol_trailing_update", torch.float32),
            "lu_rowsolve_tiles": Capture(dist_lu, "lu_rowsolve_tiles", torch.float32)}
    out["posv_auto"] = run("posv", a, b, caps=[caps[k] for k in (
        "summa_update", "chol_panel_tiles", "chol_trailing_update")])
    out["posv_auto_ozaki"] = run("posv", a, b, {Option.ResidualImpl: "ozaki"})
    out["posv_off"] = run("posv", a, b, {Option.MixedPrecision: "off"})
    del a, b
    torch.cuda.empty_cache()
    n = MIXED_GESV_N
    out["gesv_auto"] = gesv_ladder_case(165, n, mesh, mp, kernels, torch,
                                        caps=[caps["lu_rowsolve_tiles"]])
    out["gesv_auto_seeds"] = [gesv_ladder_case(s, n, mesh, mp, kernels, torch)
                              for s in GESV_LADDER_SEEDS]
    with planted_unit_linv_fault(kernels, 0.0):
        out["gesv_auto_planted"] = gesv_ladder_case(165, n, mesh, mp, kernels, torch,
                                                    opts=ir_alone())
    a = lu_matrix("pp", n, f64, SEED + 165, torch)
    b = randn((n, NRHS), f64, SEED + 166, torch)
    out["gesv_off"] = run("gesv", a, b, {Option.MixedPrecision: "off"})
    del a, b
    torch.cuda.empty_cache()
    # cond 1e12: beyond the f32 factor (the CPU parity test decides the same
    # ladder in both packages at n = 96: escalated_gmres +1, fallback +1)
    n = MIXED_ESC_N
    rng = np.random.default_rng(SEED + 167)
    q1 = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, n))).cuda())[0]
    q2 = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, n))).cuda())[0]
    a = (q1 * torch.logspace(0, -12, n, dtype=f64, device="cuda")) @ q2
    b = torch.from_numpy(rng.standard_normal((n, 1))).cuda()
    del q1, q2
    out["gesv_escalation"] = run("gesv", a, b)
    del a, b
    n = MIXED_FT_N
    a = dominant_spd(n, f64, SEED + 168, torch)
    b = randn((n, NRHS), f64, SEED + 169, torch)
    out["posv_ft"] = run("posv", a, b, {Option.FaultTolerance: "correct"})
    del a, b
    torch.cuda.empty_cache()
    gesv_limit = GESV_LADDER_OMEGA * out["gesv_auto"]["omega_gate"]
    out["gesv_omega_limit"] = gesv_limit
    out["gesv_auto_planted"]["faults"] = ladder_faults(out["gesv_auto_planted"], gesv_limit)
    emit(out)
    for key in ("posv_off", "gesv_off", "gesv_escalation"):
        r = out[key]
        check(r["info"] == 0 and r["x_finite"], f"mixed {key}: info {r['info']}")
        check(r["eta"] < r["eta_gate"] and r["omega"] < r["omega_gate"], f"mixed {key}: {r}")
    ladder = [(k, out[k], out[k]["omega_gate"]) for k in ("posv_auto", "posv_auto_ozaki", "posv_ft")]
    ladder += [("gesv_auto", out["gesv_auto"], gesv_limit)]
    ladder += [(f"gesv_auto[seed {s}]", r, gesv_limit)
               for s, r in zip(GESV_LADDER_SEEDS, out["gesv_auto_seeds"])]
    for key, r, limit in ladder:
        check(not ladder_faults(r, limit), f"mixed {key}: fails {ladder_faults(r, limit)}: {r}")
    check(out["gesv_auto_planted"]["faults"],
          f"mixed gesv_auto: a dropped unit-L^-1 slab passes every gate: {out['gesv_auto_planted']}")
    check(out["posv_auto"]["launches"]["summa_update"] > 0, "mixed posv: no summa_update launch")
    for key in ("posv_off", "gesv_off"):
        check(out[key]["tier"] == "direct", f"mixed {key}: the ladder ran under off")
    esc = out["gesv_escalation"]["ir_deltas"]
    check(esc.get("escalated_gmres") == 1 and esc.get("fallback") == 1,
          f"mixed escalation: {esc}")
    return ladder_kernels_phase(kernels, caps, out["posv_auto"]["launches"]["summa_update"], torch)


# ---------------------------------------------------------------------------
# slice 4c: the mesh BLAS-3, the mesh inverses and estimators, the ABFT her2k
# ---------------------------------------------------------------------------

BLAS3_N = {"float32": GEMM_N, "float64": GEMM_N // 2}
BLAS3_THIN = 1024  # HemmA's B: n x 1024, which select_hemm_method gives HemmA
INVERSE_N = {("potri", "float32"): 16384, ("potri", "float64"): 8192,
             ("getri", "float32"): 8192, ("getri", "float64"): 4096}
FT_HER2K_N = {"float64": 8192, "float32": 16384}
CONDEST_OVER = 10  # the estimate of rcond within 10x of 1 / kappa_1
CONDEST_ROUNDING = 1e-3  # the probe sweeps' rounding, relative (the driver's X reads it)


def product_ratio(out, ref64, k, terms, eps, amax, bmax):
    """Largest |out - ref| / bound over the entries, ``ref64`` the f64
    product.  The bound is gemm_tol's random walk of k terms (``terms``
    products summed) plus 2 sqrt(k) eps |ref| entry by entry: where the k
    terms share a sign (herk's diagonal, sum a_ik^2, grows as k) the
    rounding grows with the entry, as in the probabilistic bound
    sqrt(k) eps (|A||B|)_ij of Higham and Mary.  A TF32 product (~4e3 f32
    eps per term) still lies far outside."""
    bound = ref64.abs().mul_(2 * math.sqrt(k) * eps).add_(terms * gemm_tol(k, eps, amax, bmax, 0))
    return float(((out.double() - ref64).abs_() / bound).max())


def mesh_blas3_phase(dtype, mp, torch):
    """The mesh BLAS-3 of slice 4c on a virtual 2 x 4 mesh (nb = 256) at
    f32 n = 16384 / f64 n = 8192: hemm_summa Left under HemmC (B n x n)
    and HemmA (B n x 1024, the rule's pick), hemm_summa Right, her2k_dist
    full (k = n), trmm_dist Left lower, herk_dist and trsm_dist_right on a
    diagonally dominant triangle.  For each: seconds after one warm-up
    (operands already distributed), peak memory, the error against an f64
    product on the card held to product_ratio's bound (gemm_tol over k = n
    terms, twice for the rank-2k, plus 2 sqrt(k) eps |C| per entry; the
    solve's residual X L - B), and the lookahead 0 run bitwise the
    lookahead 1 run.  In f32, H B at TF32 is the control: it must read
    outside the bound."""
    from slate_tpu_torch.types import Diag, MethodHemm, Op, Side, Uplo, select_hemm_method

    name = dname(dtype)
    n = BLAS3_N[name]
    eps = torch.finfo(dtype).eps
    mesh = mp.make_mesh(P, Q, device="cuda")
    g = randn((n, n), dtype, SEED + 201, torch)
    h = (g + g.T) / 2
    b = randn((n, n), dtype, SEED + 202, torch)
    thin = randn((n, BLAS3_THIN), dtype, SEED + 203, torch)
    tri = dominant_spd(n, dtype, SEED + 204, torch)  # its lower triangle: diag n + uniform
    gd, hd, bd = (mp.from_dense(x, mesh, NB) for x in (g, h, b))
    thd = mp.from_dense(thin, mesh, NB)
    trd = mp.from_dense(tri, mesh, NB, diag_pad_one=True)
    hmax, gmax, bmax = (float(x.abs().max()) for x in (h, g, b))
    check(select_hemm_method(hd.mt, bd.nt) == MethodHemm.HemmC
          and select_hemm_method(hd.mt, thd.nt) == MethodHemm.HemmA,
          f"mesh_blas3 {name}: the rule picks {select_hemm_method(hd.mt, bd.nt)} / "
          f"{select_hemm_method(hd.mt, thd.nt)}")

    def l64(x):
        return x.double().tril()

    # (label, op(lookahead) -> DistMatrix, f64 reference, gemm_tol's operand
    # scales, products summed, the operation's flops); herk has no lookahead
    n3 = n * n * n
    cases = (
        ("hemm_left_hemmc", lambda la: mp.hemm_summa(Side.Left, 1.0, hd, bd, lookahead=la),
         lambda: h.double() @ b.double(), (hmax, bmax), 1, 2 * n3),
        ("hemm_left_hemma", lambda la: mp.hemm_summa(Side.Left, 1.0, hd, thd, lookahead=la),
         lambda: h.double() @ thin.double(), (hmax, float(thin.abs().max())), 1,
         2 * n * n * BLAS3_THIN),
        ("hemm_right", lambda la: mp.hemm_summa(Side.Right, 1.0, hd, bd, lookahead=la),
         lambda: b.double() @ h.double(), (bmax, hmax), 1, 2 * n3),
        ("her2k_full", lambda la: mp.her2k_dist(1.0, gd, bd, full=True, lookahead=la),
         lambda: g.double() @ b.double().T + b.double() @ g.double().T, (gmax, bmax), 2, 4 * n3),
        ("trmm_left_lower", lambda la: mp.trmm_dist(Side.Left, Uplo.Lower, Op.NoTrans,
                                                    Diag.NonUnit, 1.0, gd, bd, lookahead=la),
         lambda: l64(g) @ b.double(), (gmax, bmax), 1, n3),
        ("herk_full", lambda la: mp.herk_dist(1.0, gd, full=True),
         lambda: g.double() @ g.double().T, (gmax, gmax), 1, n3),
        ("trsm_right_lower", lambda la: mp.trsm_dist_right(trd, bd, Uplo.Lower, Op.NoTrans,
                                                           lookahead=la),
         None, None, 1, n3),
    )
    out = {}
    for label, run, ref_fn, scales, terms, flops in cases:
        run(1)  # warm-up: handles, allocator
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        d, seconds = timed(lambda: run(1), torch)
        peak = torch.cuda.max_memory_allocated()
        x = mp.to_dense(d)
        del d
        bitwise = bool(torch.equal(mp.to_dense(run(0)), x))
        if ref_fn is None:
            # X L = B: the residual of the solve, in f64, X L's products as the bound's
            ratio = product_ratio(x.double() @ l64(tri), b.double(), n, 1, eps,
                                  float(x.abs().max()), float(tri.abs().max()))
            err = float((x.double() @ l64(tri) - b.double()).abs().max())
        else:
            ref = ref_fn()
            ratio = product_ratio(x, ref, n, terms, eps, *scales)
            err = float((x.double() - ref).abs().max())
            del ref
        out[label] = {"seconds": seconds, "peak_mem_bytes": peak, "max_abs_err_vs_f64": err,
                      "err_over_tol": ratio, "lookahead_0_1_bitwise": bitwise,
                      "tflops": flops / seconds / 1e12, "shape": list(x.shape)}
        del x
        torch.cuda.empty_cache()
    # the control: H B at TF32 must read outside the same bound
    tf32 = None
    if dtype == torch.float32:
        flags = torch.backends.cuda.matmul
        old = flags.allow_tf32
        flags.allow_tf32 = True
        try:
            x = h @ b
        finally:
            flags.allow_tf32 = old
        tf32 = product_ratio(x, h.double() @ b.double(), n, 1, eps, hmax, bmax)
        del x
        torch.cuda.empty_cache()
    emit({"phase": f"mesh_blas3_{name}", "n": n, "nb": NB, "grid": [P, Q], "thin": BLAS3_THIN,
          "ops": out, "tf32_control_over_tol": tf32})
    for label, v in out.items():
        check(v["err_over_tol"] < 1, f"mesh_blas3 {name} {label}: error {v}")
        check(v["lookahead_0_1_bitwise"], f"mesh_blas3 {name} {label}: lookahead 0 != 1")
    check(tf32 is None or tf32 > 1, f"mesh_blas3 {name}: a TF32 product passes ({tf32})")
    del g, h, b, thin, tri, gd, hd, bd, thd, trd
    torch.cuda.empty_cache()


def inverse_gate(a, x, torch):
    """max|A X - I| / (n eps max|A| max|X|) with the product in f64, and
    rho = ||I - A X||_1 (the computed inverse's own error scale)."""
    n = a.shape[0]
    r = a.double() @ x.double()
    r.diagonal().sub_(1)
    ratio = float(r.abs().max()) / (n * torch.finfo(a.dtype).eps * float(a.abs().max())
                                    * float(x.abs().max()))
    rho = float(r.abs().sum(dim=0).max())
    return ratio, rho


class Keep:
    """Stands in for a function in the module that calls it, for one driver
    run, and keeps what its last call returned."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn, self.result = getattr(module, name), None

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def __call__(self, *args, **kw):
        self.result = self.fn(*args, **kw)
        return self.result


def norm1(x):
    return float(x.abs().sum(dim=0).max())


def factor_readings(a, fac, perm, x, torch, mp):
    """In f64 by the library: ||M^-1||_1, M the product of the factor
    (L L^T, or P^T L U), the matrix whose inverse the estimator probes;
    and the driver's X against M^-1, ||X - M^-1||_1 / ||M^-1||_1: the
    rounding of the sweeps the probes also run."""
    d = mp.to_dense(fac).double()
    if perm is None:
        low = d.tril()
        m = low @ low.T
    else:
        low = d.tril(-1)
        low.diagonal().fill_(1)
        m = low @ d.triu()
    del d, low
    minv = torch.linalg.inv(m)
    del m
    if perm is not None:
        minv = minv[:, torch.argsort(perm[: a.shape[0]])]  # (P^T L U)^-1 = (L U)^-1 P
    minv1 = norm1(minv)
    return minv1, norm1(minv.sub_(x.double())) / minv1


def mesh_inverse_phase(dtype, kernels, mp, bucket_plan, torch):
    """potri_mesh (f32 n = 16384 / f64 8192, a diagonally dominant SPD
    matrix) and getri_mesh (f32 8192 / f64 4096, uniform[-1, 1)) on a
    virtual 2 x 4 mesh: info 0, max|A X - I| / (n eps max|A| max|X|) < 100,
    seconds, peak memory, and each kernel's launches equal to the count
    derived from the loop (potrf_dist's panels and trailing updates; the
    partial-pivot factor's nt panel rows).  Then pocondest_dist /
    gecondest_dist on the factor each driver made (kept from its run):
    kappa_1 = ||A||_1 ||A^-1||_1 with A^-1 from torch.linalg.inv in f64,
    not from the port.  The estimate of ||A^-1||_1 is a lower bound of
    the norm of the inverse of the factor's product M, up to the probe
    sweeps' rounding, which the driver's X reads (||X - M^-1|| / ||M^-1||
    under CONDEST_ROUNDING).  So rcond kappa_1 may not be under
    (||A^-1||_1 / ||M^-1||_1) / (1 + CONDEST_ROUNDING), M^-1 from the
    library in f64 too; and it must be within 10x of 1."""
    from slate_tpu_torch.types import Norm

    drivers = importlib.import_module("slate_tpu_torch.parallel.drivers")
    name = dname(dtype)
    mesh = mp.make_mesh(P, Q, device="cuda")
    warm = WARMUP_N
    mp.potri_mesh(dominant_spd(warm, dtype, SEED + 210, torch), mesh, NB)
    mp.getri_mesh(lu_matrix("pp", warm, dtype, SEED + 211, torch), mesh, NB)
    out, counts = {}, {}
    for kind in ("potri", "getri"):
        n = INVERSE_N[(kind, name)]
        nt = n // NB
        a = (dominant_spd(n, dtype, SEED + 212, torch) if kind == "potri"
             else lu_matrix("pp", n, dtype, SEED + 213, torch))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        drv = mp.potri_mesh if kind == "potri" else mp.getri_mesh
        with Keep(drivers, "potrf_mesh" if kind == "potri" else "getrf_mesh") as kept:
            (x, info), seconds = timed(lambda: drv(a, mesh, NB), torch)
        counts[kind] = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated()
        want = (expected_potrf_launches(nt, 1, bucket_plan) if kind == "potri"
                else {"lu_rowsolve_tiles": nt})
        ratio, rho = inverse_gate(a, x, torch)
        fac, perm = kept.result[0], (None if kind == "potri" else kept.result[1])
        finfo = kept.result[-1]
        kept.result = None
        torch.cuda.empty_cache()
        # the yardstick: A^-1 in f64 by the library, not by the port
        ainv1 = norm1(torch.linalg.inv(a.double()))
        anorm1 = norm1(a.double())
        kappa = anorm1 * ainv1
        minv1, x_err = factor_readings(a, fac, perm, x, torch, mp)
        del x
        torch.cuda.empty_cache()
        anorm = mp.norm_dist(Norm.One, mp.from_dense(a, mesh, NB))
        if kind == "potri":
            rc, est_s = timed(lambda: mp.pocondest_dist(fac, anorm), torch)
        else:
            rc, est_s = timed(lambda: mp.gecondest_dist(fac, perm, anorm), torch)
        rc = float(rc)
        lower = ainv1 / minv1 / (1 + CONDEST_ROUNDING)
        out[kind] = {"n": n, "info": int(info), "seconds": seconds, "peak_mem_bytes": peak,
                     "resid_ratio": ratio, "rho": rho, "launches": {k: counts[kind][k] for k in want},
                     "expected_launches": want, "rcond_est": rc, "inv_kappa1": 1 / kappa,
                     "est_over_inv_kappa": rc * kappa, "lower_limit": lower,
                     "factor_inv_over_inv": minv1 / ainv1, "x_vs_factor_inverse": x_err,
                     "factor_info": int(finfo), "condest_seconds": est_s,
                     "anorm1_dist_over_f64": float(anorm) / anorm1}
        del a, fac, perm
        torch.cuda.empty_cache()
    emit({"phase": f"mesh_inverse_{name}", "nb": NB, "grid": [P, Q], "runs": out})
    for kind, v in out.items():
        check(v["info"] == 0 and v["factor_info"] == 0, f"{kind}_mesh {name}: info {v}")
        check(v["resid_ratio"] < 100, f"{kind}_mesh {name}: |A X - I| ratio {v['resid_ratio']}")
        for k, c in v["expected_launches"].items():
            check(v["launches"][k] == c, f"{kind}_mesh {name}: {v['launches'][k]} {k} launches, "
                                         f"expected {c}")
        check(v["x_vs_factor_inverse"] < CONDEST_ROUNDING,
              f"{kind}_mesh {name}: the sweeps' rounding {v['x_vs_factor_inverse']}")
        check(v["lower_limit"] <= v["est_over_inv_kappa"] <= CONDEST_OVER,
              f"{kind} condest {name}: {v}")
    return counts


def ft_her2k_phase(mp, torch):
    """her2k_mesh under Option.FaultTolerance (virtual 2 x 4, nb = 256): in
    f64 at n = 8192 a clean run against the plain her2k_mesh (report clean,
    the overhead), then a seeded trailing fault (31) under Correct, which
    must be detected, name the injected tile and end corrected within
    1e-12 max|C| of the clean result; in f32 at n = 16384 the same fault's
    action and floor ratio (slate_tpu's threshold, 64 ops eps mt max|C|,
    is blind there, as for the other FT phases)."""
    from slate_tpu_torch.ft import FaultPlan, FtPolicy, abft, checksum, fault_scope, inject
    from slate_tpu_torch.types import Option

    mesh = mp.make_mesh(P, Q, device="cuda")
    w = randn((FT_WARMUP_N, FT_WARMUP_N), torch.float64, SEED + 220, torch)
    abft.her2k_ft(1.0, w, w, mesh, NB, policy=FtPolicy.Detect)
    mp.her2k_mesh(1.0, w, w, mesh, NB)
    del w
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = dname(dtype)
        n = FT_HER2K_N[name]
        mt = kt = n // NB
        a = randn((n, n), dtype, SEED + 221, torch)
        b = randn((n, n), dtype, SEED + 222, torch)
        plain, plain_s = timed(lambda: mp.her2k_mesh(1.0, a, b, mesh, NB), torch)
        torch.cuda.reset_peak_memory_stats()
        clean, ft_s = timed(lambda: mp.her2k_mesh(1.0, a, b, mesh, NB,
                                                  opts={Option.FaultTolerance: "correct"}), torch)
        peak = torch.cuda.max_memory_allocated()
        _, rep0 = abft.her2k_ft(1.0, a, b, mesh, NB, policy=FtPolicy.Detect)
        cmax = float(clean.abs().max())
        f = inject.seeded_fault(31, "her2k", kt, (P, Q), phase="trailing")
        with fault_scope(FaultPlan([f])):
            (c, rep), s = timed(lambda: abft.her2k_ft(1.0, a, b, mesh, NB,
                                                      policy=FtPolicy.Correct), torch)
        wheres = [tuple(d["where"]) for d in rep.detections]
        out[name] = {"n": n, "clean_report": rep0.clean, "seconds": ft_s,
                     "plain_seconds": plain_s, "overhead": ft_s / plain_s, "peak_mem_bytes": peak,
                     "max_abs_diff_clean_vs_plain": float((clean - plain).abs().max()),
                     "fault": fault_fields(f), "action": rep.action, "detections": wheres,
                     "names_tile": any(f.ti in wh or f.tj in wh for wh in wheres),
                     "fault_seconds": s,
                     "rel_diff_vs_clean": float((c - clean).abs().max()) / cmax,
                     "floor_ratio": floor_ratio(c - clean, c, (kt + mt) * NB, mt, NB, checksum)}
        del a, b, plain, clean, c
        torch.cuda.empty_cache()
    emit({"phase": "ft_her2k", "nb": NB, "grid": [P, Q], "runs": out})
    v = out["float64"]
    check(v["clean_report"] and v["action"] == "corrected" and v["names_tile"]
          and v["rel_diff_vs_clean"] < 1e-12, f"ft_her2k float64: {v}")
    v = out["float32"]
    check(v["clean_report"], f"ft_her2k float32: clean run {v}")
    if v["action"] == "clean":  # below the reference's threshold: its decision too
        check(v["floor_ratio"] < 1, f"ft_her2k float32: undetected at floor ratio {v}")
    else:
        check(v["action"] == "corrected" and v["names_tile"], f"ft_her2k float32: {v}")


def mixed_smoke_phase():
    """``python -m slate_tpu_torch.parallel.mixed_smoke``'s run on the card."""
    from slate_tpu_torch.parallel import mixed_smoke

    res = mixed_smoke.run_smoke("cuda")
    emit({"phase": "mixed_smoke", **res})
    check(res["ok"], f"mixed smoke failed: {res['failures']}")


def ft_smoke_phase():
    """``python -m slate_tpu_torch.ft.smoke --device cuda``'s run."""
    from slate_tpu_torch.ft import smoke

    res = smoke.run_smoke("cuda")
    emit({"phase": "ft_smoke", **res})
    check(res["ok"] and len(res["scenarios"]) == 8 and res["report"]["ok"],
          f"ft smoke failed: {res['scenarios']} {res['report']}")


EIG_NB = 64  # heev_mesh / svd_mesh's default band width
# f64 cut from 4096 to 2048: the chase is an eager host
# loop, 12.5 s (hb2st) and 20.9 s (tb2bd) of the f64 4096 runs on the H100.
# f32 cut from 8192 to 6144 for slice 10a's phase: svd_mesh first (40.38 s
# of a 595.7 s script at 8192; the chase is the host-bound share), then
# heev_mesh when a full run with the obs phase left under 40 s under 600
# (588.3 s; heev_mesh f32 8192 24.87 s there)
EIG_MESH_N = {"float32": 6144, "float64": 2048}
EIG_SINGLE_N, EIG_SINGLE_NB = 2048, 32
EIG_WARMUP_N = 256
EIG_VALUE_C = 1.0  # eigen/singular values within EIG_VALUE_C n eps ||A||_2 of the f64 library's


class Timed:
    """Stands in for a function in its module for one driver run: times
    each call to the card's completion (one synchronize before and after)
    and adds the seconds to ``split[label]``."""

    def __init__(self, module, name, split, label, torch):
        self.module, self.name, self.split, self.label, self.torch = module, name, split, label, torch
        self.fn = getattr(module, name)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def __call__(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.split[self.label] = self.split.get(self.label, 0.0) + time.perf_counter() - t0
        return out


class PanelTap:
    """Stands in for ``qr_panel_offset`` in ``linalg.qr`` for one driver
    run: hands every call on, and keeps the first and the last call's
    (panel, row0) as the path gave them."""

    def __init__(self, qr):
        self.qr, self.wrapper, self.first, self.last = qr, qr.qr_panel_offset, None, None

    def __enter__(self):
        self.qr.qr_panel_offset = self
        return self

    def __exit__(self, *exc):
        self.qr.qr_panel_offset = self.wrapper

    def __call__(self, a, row0):
        kept = (a.clone(), row0)
        if self.first is None:
            self.first = kept
        self.last = kept
        return self.wrapper(a, row0)


def eig_readings(a, w, z, torch):
    """heev's gates: max|A Z - Z diag(w)| / (max|A| n) and max|Z^H Z - I|,
    each as a ratio to 100 n eps; w against torch.linalg.eigvalsh in f64
    as a ratio to EIG_VALUE_C n eps ||A||_2."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    gate = 100 * n * eps
    resid = float((a @ z - z * w).abs().max() / (a.abs().max() * n))
    eye = torch.eye(n, dtype=z.dtype, device=z.device)
    orth = float((z.conj().T @ z - eye).abs().max())
    ref = torch.linalg.eigvalsh(a.double())
    norm2 = float(ref.abs().max())
    werr = float((w.double() - ref).abs().max())
    return {"resid": resid, "orth": orth, "resid_ratio": resid / gate, "orth_ratio": orth / gate,
            "w_err": werr, "w_ratio": werr / (EIG_VALUE_C * n * eps * norm2), "norm2": norm2}


def svd_readings(a, u, s, vh, torch):
    """svd's gates: max|A - U diag(s) Vh| / (max|A| n), max|U^H U - I|,
    max|Vh Vh^H - I|, each as a ratio to 100 n eps; s against
    torch.linalg.svdvals in f64 as a ratio to EIG_VALUE_C n eps s_max.
    For an f64 A the reference is cuSOLVER's gesvd (QR iteration): the
    default Jacobi driver read 2.1e-10 off at 4096 on the H100, 1.8x the
    f64 limit, where the port's f64 SVD holds to slate_tpu's on the CPU;
    for f32 the default's error is far below the f32 limit."""
    m, n = a.shape
    eps = torch.finfo(a.dtype).eps
    gate = 100 * max(m, n) * eps
    resid = float(((u * s) @ vh - a).abs().max() / (a.abs().max() * max(m, n)))
    k = s.shape[0]
    eye = torch.eye(k, dtype=u.dtype, device=u.device)
    orth_u = float((u.conj().T @ u - eye).abs().max())
    orth_v = float((vh @ vh.conj().T - eye).abs().max())
    t0 = time.perf_counter()
    driver = "gesvd" if a.dtype == torch.float64 else None
    ref = torch.linalg.svdvals(a.double(), driver=driver)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    serr = float((s.double() - ref).abs().max())
    return {"resid": resid, "orth_u": orth_u, "orth_v": orth_v, "resid_ratio": resid / gate,
            "orth_u_ratio": orth_u / gate, "orth_v_ratio": orth_v / gate, "s_err": serr,
            "s_ratio": serr / (EIG_VALUE_C * max(m, n) * eps * float(ref[0])),
            "svdvals_f64_seconds": ref_s, "svdvals_driver": driver or "default"}


def readings_ok(r):
    return all(v <= 1 for k, v in r.items() if k.endswith("_ratio"))


def sym_operand(n, dtype, seed, torch):
    g = randn((n, n), dtype, seed, torch)
    return (g + g.T) / 2


def svd_lq_panels(n, nb):
    """The LQ panels ge2tb / ge2tb_dist launch: one per block k with
    (k + 1) nb < n - 1 (the later steps are the identity)."""
    return sum(1 for k in range(-(-n // nb)) if (k + 1) * nb < n - 1)


def eig_mesh_phase(dtype, kernels, mp, torch):
    """heev_mesh on the virtual 2 x 4 mesh (nb = 64, vectors, the
    distributed solver) after a warm-up at n = 256: seconds, the split
    (he2hb_dist, gather_diagband + hb2st, stedc_dist, chase_apply_dist,
    unmtr_he2hb_dist; each call timed to the card's completion), peak
    memory, the qr_panel_offset launches (one per he2hb panel, derived
    from _he2hb_panel_count) and eig_readings.  Returns (launches, the
    first and last panel the path gave the kernel)."""
    from slate_tpu_torch.linalg import eig, qr
    from slate_tpu_torch.parallel import dist_stedc, dist_twostage

    name = dname(dtype)
    n = EIG_MESH_N[name]
    mesh = mp.make_mesh(P, Q, device="cuda")
    aw = sym_operand(EIG_WARMUP_N, dtype, SEED + 140, torch)
    ww, zw = mp.heev_mesh(aw, mesh, EIG_NB)
    check(bool(torch.isfinite(zw).all()), f"eig_mesh {name}: warm-up failed")
    del aw, ww, zw
    a = sym_operand(n, dtype, SEED + 141, torch)
    split = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    with ExitStack() as st:
        tap = st.enter_context(PanelTap(qr))
        for mod, fn, label in ((dist_twostage, "he2hb_dist", "he2hb_dist"),
                               (dist_twostage, "gather_diagband", "gather_diagband+hb2st"),
                               (eig, "hb2st", "gather_diagband+hb2st"),
                               (dist_stedc, "stedc_dist", "stedc_dist"),
                               (dist_twostage, "chase_apply_dist", "chase_apply_dist"),
                               (dist_twostage, "unmtr_he2hb_dist", "unmtr_he2hb_dist")):
            st.enter_context(Timed(mod, fn, split, label, torch))
        t0 = time.perf_counter()
        w, z = mp.heev_mesh(a, mesh, EIG_NB)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    want = eig._he2hb_panel_count(n, EIG_NB)
    r = eig_readings(a, w, z, torch)
    emit({"phase": f"eig_mesh_{name}", "n": n, "nb": EIG_NB, "mesh": [P, Q], "seconds": seconds,
          "split": split, "peak_bytes": peak, "qr_panel_offset_launches": counts["qr_panel_offset"],
          "derived": want, **r})
    check(counts["qr_panel_offset"] == want,
          f"eig_mesh {name}: {counts['qr_panel_offset']} qr_panel_offset launches, derived {want}")
    check(readings_ok(r), f"eig_mesh {name}: {r}")
    del a, w, z
    torch.cuda.empty_cache()
    return counts["qr_panel_offset"], tap.first, tap.last, seconds


def svd_mesh_phase(dtype, kernels, mp, torch):
    """svd_mesh on the virtual 2 x 4 mesh (nb = 64) on a square Gaussian A
    after a warm-up: seconds, the split (ge2tb_dist, gather_diagband +
    tb2bd, bdsqr, the two chase_apply_dist, unmbr_ge2tb_u_dist,
    unmbr_ge2tb_v_dist), peak memory, the qr_panel_offset launches
    (nblocks QR panels + the LQ panels of svd_lq_panels) and svd_readings."""
    from slate_tpu_torch.linalg import svd
    from slate_tpu_torch.parallel import dist_twostage

    name = dname(dtype)
    n = EIG_MESH_N[name]
    mesh = mp.make_mesh(P, Q, device="cuda")
    aw = randn((EIG_WARMUP_N, EIG_WARMUP_N), dtype, SEED + 150, torch)
    uw, sw, vw = mp.svd_mesh(aw, mesh, EIG_NB)
    check(bool(torch.isfinite(uw).all()), f"svd_mesh {name}: warm-up failed")
    del aw, uw, sw, vw
    a = randn((n, n), dtype, SEED + 151, torch)
    split = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    with ExitStack() as st:
        for mod, fn, label in ((dist_twostage, "ge2tb_dist", "ge2tb_dist"),
                               (dist_twostage, "gather_diagband", "gather_diagband+tb2bd"),
                               (svd, "tb2bd", "gather_diagband+tb2bd"),
                               (svd, "bdsqr", "bdsqr"),
                               (dist_twostage, "chase_apply_dist", "chase_apply_dist x2"),
                               (dist_twostage, "unmbr_ge2tb_u_dist", "unmbr_ge2tb_u_dist"),
                               (dist_twostage, "unmbr_ge2tb_v_dist", "unmbr_ge2tb_v_dist")):
            st.enter_context(Timed(mod, fn, split, label, torch))
        t0 = time.perf_counter()
        u, s, vh = mp.svd_mesh(a, mesh, EIG_NB)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    want = -(-n // EIG_NB) + svd_lq_panels(n, EIG_NB)
    r = svd_readings(a, u, s, vh, torch)
    emit({"phase": f"svd_mesh_{name}", "n": n, "nb": EIG_NB, "mesh": [P, Q], "seconds": seconds,
          "split": split, "peak_bytes": peak, "qr_panel_offset_launches": counts["qr_panel_offset"],
          "derived": want, **r})
    check(counts["qr_panel_offset"] == want,
          f"svd_mesh {name}: {counts['qr_panel_offset']} qr_panel_offset launches, derived {want}")
    check(readings_ok(r), f"svd_mesh {name}: {r}")
    del a, u, s, vh
    torch.cuda.empty_cache()
    return counts["qr_panel_offset"], seconds


def eig_single_phase(kernels, torch):
    """heev_array and svd_array f32 at n = 2048, nb = 32, each after a
    warm-up at n = 256: seconds, peak memory, the qr_panel_offset launches
    (he2hb's panels; ge2tb's QR and LQ panels) and the readings."""
    from slate_tpu_torch.linalg import eig, svd

    dtype = torch.float32
    n, nb = EIG_SINGLE_N, EIG_SINGLE_NB
    out = {"phase": "eig_single", "n": n, "nb": nb}
    launches = {}
    for tag in ("heev_array", "svd_array"):
        if tag == "heev_array":
            warm, a = sym_operand(EIG_WARMUP_N, dtype, SEED + 160, torch), sym_operand(n, dtype, SEED + 161, torch)
            run = lambda x: eig.heev_array(x, nb=nb)  # noqa: E731
            want = eig._he2hb_panel_count(n, nb)
        else:
            warm, a = randn((EIG_WARMUP_N,) * 2, dtype, SEED + 162, torch), randn((n, n), dtype, SEED + 163, torch)
            run = lambda x: svd.svd_array(x, nb=nb)  # noqa: E731
            want = -(-n // nb) + svd_lq_panels(n, nb)
        run(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = run(a)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts(kernels)["qr_panel_offset"]
        r = eig_readings(a, *res, torch) if tag == "heev_array" else svd_readings(a, *res, torch)
        out[tag] = {"seconds": seconds, "peak_bytes": torch.cuda.max_memory_allocated(),
                    "qr_panel_offset_launches": got, "derived": want, **r}
        check(got == want, f"{tag}: {got} qr_panel_offset launches, derived {want}")
        check(readings_ok(r), f"{tag}: {r}")
        launches[tag] = got
    emit(out)
    torch.cuda.empty_cache()
    return launches


def kernel_qr_he2hb_phase(dtype, taps, kernels, testing, torch):
    """qr_panel_offset held against its twin at the he2hb panel shape
    (n, 64) of the eig_mesh run, on the first and the last panel the path
    gave it (row0 = 64 and n - 64): every part at its own scale, Q R = A
    and the compact-WY identity in f64, rows above row0 untouched, each
    zeroed part failing its reading; then timed on the first panel with
    its twin, the library's torch.geqrf of the panel's rows below row0
    (VR and tau, no T), the bound and the barrier floor."""
    name = dname(dtype)
    out = {"phase": f"kernel_qr_he2hb_{name}"}
    errs = []
    for tag, (a, r0) in taps.items():
        got = kernels.qr_panel_offset(a, r0)
        torch.cuda.synchronize()
        want = kernels.qr_panel_offset_plain(a, r0)
        c = testing.qr_panel_check(a, got, want, True, r0)
        out[tag] = {"shape": list(a.shape), "row0": r0, **c}
        errs.append(c["max_abs_err"])
        check(testing.qr_panel_ok(c), f"qr_panel_offset {name} he2hb {tag}: {c}")
        check(qr_mutants_fail(a, got, want, True, r0, testing),
              f"qr_panel_offset {name} he2hb {tag}: a wrong factor passed")
        check(bool((got[0][:r0] == 0).all()) and bool((got[1][:r0] == 0).all()),
              f"qr_panel_offset {name} he2hb {tag}: rows above row0 were written")
    a, r0 = taps["first"]
    m, w = a.shape
    ms = cuda_ms(lambda: kernels.qr_panel_offset(a, r0), 10, torch)
    plain_ms = cuda_ms(lambda: kernels.qr_panel_offset_plain(a, r0), 2, torch)
    library_ms = cuda_ms(lambda: torch.geqrf(a[r0:]), 10, torch)
    nbytes, flops = qr_bound(m, w, 1, name, True)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS_S[name] * 1e3
    out["timing"] = {"shape": [m, w], "row0": r0, "kernel_ms": ms, "plain_ms": plain_ms,
                     "library_ms_geqrf_no_T": library_ms, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "barrier_floor_ms": qr_barrier_floor(kernels, dtype, 1, m, w)}
    emit(out)
    return {"shape": [m, w], "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": out["timing"]["bound_ms"], "bound_by": out["timing"]["bound_by"],
            "library_ms": library_ms}


# slice 7a: the band solvers.  Single chip: pbsv_array's windowed factor
# (nb = 64 at kd = 128) and gbsv_array's (nb = 32 at kl = ku = 64); the wide
# route of pbsv_array (4 kd > n: potrf_array, the scan form in f32 above
# n = 16384, n / 256 chol_diag_inv launches); on the mesh (2 x 4, nb = 256)
# pbsv_mesh, gbsv_mesh and tbsm_mesh.  The narrow and mesh band paths call
# no hand kernel (slate_tpu computes them outside Pallas): their counts
# must stay 0.
BAND_PB = (("float32", 32768, 128), ("float64", 16384, 128))
BAND_GB = (("float32", 16384, 64), ("float64", 8192, 64))
BAND_WIDE = (20480, 8192)  # f32 (n, kd): band_worthwhile false
BAND_MESH_PB = (("float32", 32768, 512), ("float64", 16384, 512))
BAND_MESH_GB = (("float32", 8192, 256), ("float64", 4096, 256))
BAND_TBSM = (8192, 256)  # f32 (n, kd)
BAND_WARMUP_N = 1024


def band_operand(n, kl, ku, dtype, seed, torch, spd=False):
    """uniform[-1, 1) on the band [-kl, ku], zero elsewhere, made on the
    device; ``spd``: the symmetric band (kl = ku = kd) plus (2 kd + 1) I,
    diagonally dominant, hence SPD."""
    a = torch.rand((n, n), generator=torch.Generator(device="cuda").manual_seed(seed),
                   dtype=dtype, device="cuda")
    a.mul_(2).sub_(1).triu_(-kl).tril_(ku)
    if spd:
        a.tril_()
        a.add_(a.tril(-1).T)
        a.diagonal().add_(2 * kl + 1)
    return a


def hand_launches(kernels):
    """Every counted kernel's launches since the last reset_counts, the
    ones that launched only."""
    return {k: v for k, v in read_counts(kernels).items() if v}


def pb_factor_ratio(a, l, torch, rows=4096):
    """The band factor against the library's dense factor of the same
    band in f64: max|L - L_lib| / (n eps max|A|), eps of the factor (the
    difference taken over blocks of rows)."""
    l64 = torch.linalg.cholesky(a.double())
    d = max(float((l[r0:r0 + rows].double() - l64[r0:r0 + rows]).abs().max())
            for r0 in range(0, a.shape[0], rows))
    del l64
    return d / (a.shape[0] * torch.finfo(a.dtype).eps * float(a.abs().max()))


def gb_rebuild_ratio(a, f, torch):
    """P A = L U rebuilt from the windowed factor, in f64: U's rows, then,
    window by window from the last, L_k's unit-lower block applied and
    P_k's window-local permutation undone (LAPACK gbtrf's A = P_0 L_0 ...
    P_s L_s U); max|A - rebuilt| / (n eps max|A|), eps of the factor."""
    n = a.shape[0]
    nb = f.nb
    nsteps, wr = f.perms.shape
    lu = f.lu.double()
    m = torch.zeros((nsteps * nb + wr, n), dtype=torch.float64, device=a.device)
    m[:n] = lu.triu()
    eye = torch.eye(nb, dtype=torch.float64, device=a.device)
    perms = f.perms.long()
    for k in range(nsteps - 1, -1, -1):
        kk = k * nb
        lw = torch.zeros((wr, nb), dtype=torch.float64, device=a.device)
        blk = lu[kk:kk + wr, kk:kk + nb]
        lw[:blk.shape[0], :blk.shape[1]] = blk
        win = m[kk:kk + wr]
        top = win[:nb].clone()
        new = torch.empty_like(win)
        new[:nb] = (lw[:nb].tril(-1) + eye) @ top
        new[nb:] = win[nb:] + lw[nb:] @ top
        win[perms[k]] = new
    r = float((m[:n] - a.double()).abs().max() / (n * torch.finfo(a.dtype).eps
                                                   * a.abs().max().double()))
    del m, lu
    return r


def band_single_phase(kernels, posv_seconds, torch):
    """pbsv_array f32 n = 32768 / f64 16384 at kd = 128 and gbsv_array f32
    n = 16384 / f64 8192 at kl = ku = 64 (the windowed routes), each after a
    warm-up at n = 1024: info, eta (and omega for gbsv), seconds, peak
    memory, no hand-kernel launch; the factor's reading against the
    library's dense f64 factor (pb) or the rebuilt P A = L U (gb); the band
    time against the dense solve of the same size (posv f32 32768 as phase
    4 timed it; gesv_array on the f64 gb operand)."""
    from slate_tpu_torch.linalg import band, chol, lu

    out = {"phase": "band_single"}
    for name, n, kd in BAND_PB:
        dtype = getattr(torch, name)
        check(band.band_worthwhile(n, kd), f"pbsv {name}: not the windowed route")
        aw = band_operand(BAND_WARMUP_N, kd, kd, dtype, SEED + 200, torch, spd=True)
        chol.pbsv_array(aw, aw[:, :NRHS].clone(), kd)
        del aw
        a = band_operand(n, kd, kd, dtype, SEED + 201, torch, spd=True)
        b = randn((n, NRHS), dtype, SEED + 202, torch)
        reset_counts(kernels)
        (x, f, info), seconds, peak = timed_solve(lambda: chol.pbsv_array(a, b, kd), torch)
        launched = hand_launches(kernels)
        e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
        res = {"n": n, "kd": kd, "nb": band._pick_nb(kd), "info": int(info), "eta": e,
               "eta_gate": gate, "seconds": seconds, "peak_mem_bytes": peak,
               "hand_kernel_launches": launched, "factor_ratio": pb_factor_ratio(a, f, torch)}
        if name == "float32":
            res["dense_posv_seconds"] = posv_seconds
            res["band_over_dense"] = seconds / posv_seconds
        out[f"pbsv_{name}"] = res
        check(int(info) == 0, f"pbsv {name}: info {int(info)}")
        check(e < gate, f"pbsv {name}: eta {e} >= {gate}")
        check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()), f"pbsv {name}: bad X")
        check(not launched, f"pbsv {name}: hand kernels launched {launched}")
        del a, b, x, f
        torch.cuda.empty_cache()
    for name, n, kl in BAND_GB:
        dtype = getattr(torch, name)
        check(band.band_worthwhile(n, 2 * kl), f"gbsv {name}: not the windowed route")
        aw = band_operand(BAND_WARMUP_N, kl, kl, dtype, SEED + 203, torch)
        lu.gbsv_array(aw, aw[:, :NRHS].clone(), kl, kl)
        del aw
        a = band_operand(n, kl, kl, dtype, SEED + 204, torch)
        b = randn((n, NRHS), dtype, SEED + 205, torch)
        reset_counts(kernels)
        (x, f), seconds, peak = timed_solve(lambda: lu.gbsv_array(a, b, kl, kl), torch)
        launched = hand_launches(kernels)
        check(type(f).__name__ == "BandLU", f"gbsv {name}: factor {type(f).__name__}")
        res = {"n": n, "kl": kl, "ku": kl, "nb": f.nb, "seconds": seconds, "peak_mem_bytes": peak,
               "pivoted_windows": int((f.perms != torch.arange(f.perms.shape[1], device="cuda"))
                                      .any(dim=1).sum()),
               "hand_kernel_launches": launched,
               **lu_solve_gates(a, x, b, f.info, f"gbsv {name}", torch),
               "rebuild_ratio": gb_rebuild_ratio(a, f, torch)}
        if name == "float64":
            (xd, _), dense_seconds, _ = timed_solve(lambda: lu.gesv_array(a, b), torch)
            res["dense_gesv_seconds"] = dense_seconds
            res["band_over_dense"] = seconds / dense_seconds
            del xd
        out[f"gbsv_{name}"] = res
        check(not launched, f"gbsv {name}: hand kernels launched {launched}")
        del a, b, x, f
        torch.cuda.empty_cache()
    emit(out)


def band_wide_phase(kernels, torch):
    """pbsv_array f32 at n = 20480, kd = 8192: 4 kd > n, so potrf_array on
    the band-projected operand, which above n = 16384 is the scan form:
    n / 256 chol_diag_inv launches, read right after the path.  Returns
    them."""
    from slate_tpu_torch.linalg import band, chol

    n, kd = BAND_WIDE
    dtype = torch.float32
    check(not band.band_worthwhile(n, kd), "band_wide: the windowed route")
    aw = band_operand(2048, 1024, 1024, dtype, SEED + 210, torch, spd=True)
    chol.pbsv_array(aw, aw[:, :NRHS].clone(), 1024)
    del aw
    a = band_operand(n, kd, kd, dtype, SEED + 211, torch, spd=True)
    b = randn((n, NRHS), dtype, SEED + 212, torch)
    reset_counts(kernels)
    (x, f, info), seconds, peak = timed_solve(lambda: chol.pbsv_array(a, b, kd), torch)
    got = read_counts(kernels)
    want = -(-n // NB)  # chol._potrf_scan: one diagonal block a 256-wide step
    e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
    emit({"phase": "band_wide", "n": n, "kd": kd, "info": int(info), "eta": e, "eta_gate": gate,
          "seconds": seconds, "peak_mem_bytes": peak, "chol_diag_inv_launches": got["chol_diag_inv"],
          "derived": want, "launches": {k: v for k, v in got.items() if v}})
    check(int(info) == 0, f"band_wide: info {int(info)}")
    check(e < gate, f"band_wide: eta {e} >= {gate}")
    check(got["chol_diag_inv"] == want, f"band_wide: {got['chol_diag_inv']} chol_diag_inv launches, "
          f"derived {want}")
    del a, b, x, f
    torch.cuda.empty_cache()
    return got["chol_diag_inv"]


def band_mesh_phase(kernels, mp, torch):
    """pbsv_mesh f32 n = 32768 / f64 16384 at kd = 512, gbsv_mesh f32 8192 /
    f64 4096 at kl = ku = 256 and tbsm_mesh f32 8192 (kd = 256, with and
    without a row permutation) on the virtual 2 x 4 mesh at nb = 256, each
    after a warm-up at n = 1024: info, eta (omega for gbsv), seconds, the
    split (factor, permute, the two trsm_dist, from/to_dense), peak memory,
    no hand-kernel launch; pbtrf_band_dist at lookahead 0 and 1 bitwise."""
    from slate_tpu_torch.parallel import dist_chol, dist_lu, drivers

    mesh = mp.make_mesh(P, Q)
    out = {"phase": "band_mesh", "grid": [P, Q], "nb": NB}

    def run(fn, split):
        reset_counts(kernels)
        with ExitStack() as stack:
            for mod, fname, label in ((dist_chol, "pbtrf_band_dist", "factor"),
                                      (dist_lu, "gbtrf_band_dist", "factor"),
                                      (drivers, "permute_rows_dist", "permute"),
                                      (drivers, "trsm_dist", "trsm_dist"),
                                      (drivers, "from_dense", "from_dense"),
                                      (drivers, "to_dense", "to_dense")):
                stack.enter_context(Timed(mod, fname, split, label, torch))
            res = timed_solve(fn, torch)
        return res, hand_launches(kernels)

    for name, n, kd in BAND_MESH_PB:
        dtype = getattr(torch, name)
        aw = band_operand(BAND_WARMUP_N, kd, kd, dtype, SEED + 220, torch, spd=True)
        mp.pbsv_mesh(aw, aw[:, :NRHS].clone(), kd, mesh, NB)
        del aw
        a = band_operand(n, kd, kd, dtype, SEED + 221, torch, spd=True)
        b = randn((n, NRHS), dtype, SEED + 222, torch)
        split = {}
        ((x, info), seconds, peak), launched = run(lambda: mp.pbsv_mesh(a, b, kd, mesh, NB), split)
        e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
        res = {"n": n, "kd": kd, "info": int(info), "eta": e, "eta_gate": gate, "seconds": seconds,
               "split": split, "peak_mem_bytes": peak, "hand_kernel_launches": launched}
        check(int(info) == 0, f"pbsv_mesh {name}: info {int(info)}")
        check(e < gate, f"pbsv_mesh {name}: eta {e} >= {gate}")
        check(not launched, f"pbsv_mesh {name}: hand kernels launched {launched}")
        del x, b
        if name == "float32":  # lookahead 0 and 1 bitwise on the card
            ad = mp.from_dense(a, mesh, NB, diag_pad_one=True)
            l0, _ = mp.pbtrf_band_dist(ad, kd, lookahead=0)
            l1, _ = mp.pbtrf_band_dist(ad, kd, lookahead=1)
            res["lookahead_0_1_bitwise"] = bool(torch.equal(l0.tiles, l1.tiles))
            check(res["lookahead_0_1_bitwise"], "pbtrf_band_dist: lookahead 0 and 1 differ")
            del ad, l0, l1
        out[f"pbsv_mesh_{name}"] = res
        del a
        torch.cuda.empty_cache()
    for name, n, kl in BAND_MESH_GB:
        dtype = getattr(torch, name)
        aw = band_operand(BAND_WARMUP_N, kl, kl, dtype, SEED + 223, torch)
        mp.gbsv_mesh(aw, aw[:, :NRHS].clone(), kl, kl, mesh, NB)
        del aw
        a = band_operand(n, kl, kl, dtype, SEED + 224, torch)
        b = randn((n, NRHS), dtype, SEED + 225, torch)
        split = {}
        ((x, info), seconds, peak), launched = run(lambda: mp.gbsv_mesh(a, b, kl, kl, mesh, NB), split)
        res = {"n": n, "kl": kl, "ku": kl, "seconds": seconds, "split": split,
               "factor_s_per_column": split["factor"] / n, "peak_mem_bytes": peak,
               "hand_kernel_launches": launched,
               **lu_solve_gates(a, x, b, info, f"gbsv_mesh {name}", torch)}
        check(not launched, f"gbsv_mesh {name}: hand kernels launched {launched}")
        out[f"gbsv_mesh_{name}"] = res
        del a, b, x
        torch.cuda.empty_cache()
    n, kd = BAND_TBSM
    dtype = torch.float32
    a = band_operand(n, kd, 0, dtype, SEED + 226, torch)
    a.diagonal().add_(kd + 1)  # diagonally dominant: a well-conditioned triangle
    b = randn((n, NRHS), dtype, SEED + 227, torch)
    perm = torch.randperm(n, generator=torch.Generator(device="cuda").manual_seed(SEED + 228),
                          device="cuda")
    mp.tbsm_mesh(a[:BAND_WARMUP_N, :BAND_WARMUP_N], kd, b[:BAND_WARMUP_N], mesh, NB)
    for tag, pv in (("tbsm_mesh", None), ("tbsm_mesh_perm", perm)):
        split = {}
        (x, seconds, peak), launched = run(lambda: mp.tbsm_mesh(a, kd, b, mesh, NB, perm=pv), split)
        rhs = b if pv is None else b[pv]
        e, gate = eta(a, x, rhs, torch), 100 * n * torch.finfo(dtype).eps
        out[tag] = {"n": n, "kd": kd, "eta": e, "eta_gate": gate, "seconds": seconds,
                    "split": split, "peak_mem_bytes": peak, "hand_kernel_launches": launched}
        check(e < gate, f"{tag}: eta {e} >= {gate}")
        check(not launched, f"{tag}: hand kernels launched {launched}")
        del x
    del a, b, perm
    torch.cuda.empty_cache()
    emit(out)


# slice 7b: the indefinite solver, the RBT solve and redistribute.  Sized to
# seconds: the hesv chase is a host-bound eager loop (~4 n wavefront steps)
# and so is the no-pivot LU's column loop; the three phases, warm-ups and
# readings included, are held to SLICE7B_BUDGET_S on the card.  At f32 hesv
# 2048 (4.97 s) and RBT 16384 (3.17 s, NoPiv 2.98 s beside it; H100, 700 W)
# they took too much of it: cut to 1536 and 8192.
HESV_NB = 32
HESV_N = (("float32", 1536), ("float64", 1024), ("complex64", 512))
GTSV_N = 2048  # f64
RBT_N = (("float32", 8192), ("float64", 8191))  # 8191: the identity-pad path
RBT_ZERO_N = 1024  # f64, A[0, 0] = 0
REDIST_N = 16384  # f32, nb = 256, from the 2 x 4 grid
REDIST_PAD_N = 15260  # 60 tiles of 256: 60 on the 2 x 4 grid, 64 on the 1 x 8 grid
NONUNIFORM_N = 8192  # f32
NONUNIFORM_CYCLE = (256, 128, 192)
SLICE7B_WARMUP_N = 256
SLICE7B_BUDGET_S = 30.0


def uniform(shape, dtype, seed, torch):
    """uniform[-1, 1) (real and imaginary parts), made on the device."""
    u = torch.rand(shape, generator=torch.Generator(device="cuda").manual_seed(seed),
                   dtype=dtype, device="cuda")
    return u.mul_(2).sub_(1)


def hermitian_indefinite(n, dtype, seed, torch):
    """uniform[-1, 1) mirrored from its lower triangle, real diagonal:
    Hermitian, with eigenvalues of both signs."""
    u = uniform((n, n), dtype, seed, torch)
    a = u.tril()
    a.add_(u.tril(-1).mH)
    if a.is_complex():
        a.diagonal().imag.zero_()
    return a


def hesv_single_phase(kernels, testing, torch):
    """hesv_array (nb = 32) on a Hermitian indefinite uniform[-1, 1) operand
    with 32 right-hand sides, f32 n = 1536, f64 1024 and complex64 512,
    each after a warm-up at n = 256: info 0 and eta < 100 n eps; seconds,
    split into he2hb, hb2st, the Q^H apply, gtsv and the Q apply (each call
    timed to the card's completion), peak memory, and qr_panel_offset's
    launches against he2hb's panel count (0 where panel_engaged keeps the
    library pair: complex).  Then gtsv_array alone, f64 n = 2048, on a
    tridiagonal whose small diagonal makes rows swap: the share of steps
    that swapped, the error against torch.linalg.solve of the dense f64
    matrix as a ratio to n eps max|x|, and microseconds a step.  Returns
    {dtype: launches} for the real dtypes."""
    from slate_tpu_torch.linalg import eig, indefinite

    out = {"phase": "hesv_single", "nb": HESV_NB}
    launches = {}
    for name, n in HESV_N:
        dtype = getattr(torch, name)
        aw = hermitian_indefinite(SLICE7B_WARMUP_N, dtype, SEED + 300, torch)
        _, warmup_seconds, _ = timed_solve(
            lambda: indefinite.hesv_array(aw, aw[:, :NRHS].clone(), HESV_NB), torch)
        del aw
        a = hermitian_indefinite(n, dtype, SEED + 301, torch)
        b = randn((n, NRHS), dtype, SEED + 302, torch)
        split = {}
        reset_counts(kernels)
        with ExitStack() as st:
            for fn, label in (("he2hb", "he2hb"), ("hb2st", "hb2st"),
                              ("_unmtr_he2hb_adj", "q_adjoint_apply"),
                              ("_unmtr_hb2st_adj", "q_adjoint_apply"), ("gtsv_array", "gtsv"),
                              ("unmtr_hb2st", "q_apply"), ("unmtr_he2hb", "q_apply")):
                st.enter_context(Timed(indefinite, fn, split, label, torch))
            (x, f, info), seconds, peak = timed_solve(
                lambda: indefinite.hesv_array(a, b, HESV_NB), torch)
        got = read_counts(kernels)["qr_panel_offset"]
        want = eig._he2hb_panel_count(n, HESV_NB) if kernels.panel_engaged(dtype) else 0
        e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
        out[name] = {"n": n, "info": int(info), "eta": e, "eta_gate": gate, "seconds": seconds,
                     "warmup_seconds": warmup_seconds, "split": split, "peak_mem_bytes": peak,
                     "qr_panel_offset_launches": got,
                     "derived": want, "hand_kernel_launches": hand_launches(kernels)}
        check(int(info) == 0, f"hesv {name}: info {int(info)}")
        check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()), f"hesv {name}: bad X")
        check(e < gate, f"hesv {name}: eta {e} >= {gate}")
        check(got == want, f"hesv {name}: {got} qr_panel_offset launches, derived {want}")
        if want:
            launches[dtype] = got
        del a, b, x, f
        torch.cuda.empty_cache()
    # gtsv alone
    n = GTSV_N
    dtype = torch.float64
    dl, du = uniform((n - 1,), dtype, SEED + 303, torch), uniform((n - 1,), dtype, SEED + 304, torch)
    d = uniform((n,), dtype, SEED + 305, torch).mul_(1e-2)
    b = randn((n, NRHS), dtype, SEED + 306, torch)
    w = SLICE7B_WARMUP_N
    indefinite.gtsv_array(dl[:w - 1], d[:w], du[:w - 1], b[:w])
    (x, info), seconds, peak = timed_solve(lambda: indefinite.gtsv_array(dl, d, du, b), torch)
    t = torch.diag(d) + torch.diag(dl, -1) + torch.diag(du, 1)
    ref = torch.linalg.solve(t, b)
    err = float((x - ref).abs().max() / (n * torch.finfo(dtype).eps * ref.abs().max()))
    swaps = sum(testing.gtsv_swaps(dl.tolist(), d.tolist(), du.tolist()))
    out["gtsv_float64"] = {"n": n, "nrhs": NRHS, "info": int(info), "seconds": seconds,
                           "peak_mem_bytes": peak,
                           "us_per_step": seconds / (2 * n - 1) * 1e6,
                           "swap_share": swaps / (n - 1), "err_over_n_eps_xmax": err}
    emit(out)
    check(int(info) == 0, f"gtsv: info {int(info)}")
    check(err < 1, f"gtsv: error {err} n eps max|x| from the library's dense solve")
    check(0 < swaps < n - 1, f"gtsv: {swaps} of {n - 1} steps swapped")
    del dl, d, du, b, x, t, ref
    torch.cuda.empty_cache()
    return launches


def gesv_rbt_phase(kernels, torch):
    """gesv_rbt_array on uniform[-1, 1) with 32 right-hand sides, f32
    n = 8192 and f64 n = 8191 (the identity-pad path), each after a
    warm-up at n = 256: info 0 and eta < 100 n eps (gates), omega beside
    the LU family's 10 sqrt(n) eps (a reading: RBT's safety without pivots
    is probabilistic), seconds, peak memory, no hand-kernel launch (the
    no-pivot LU and its solves are library calls, as in slate_tpu);
    gesv_array NoPiv on the same operand beside it (seconds, info, eta,
    omega: readings); RBTFactors.solve on a fresh right-hand side under the
    eta gate against the original A.  Then f64 n = 1024 with A[0, 0] = 0:
    NoPiv must report a nonzero info or a non-finite X, RBT pass its
    gates."""
    from slate_tpu_torch.linalg import lu, rbt
    from slate_tpu_torch.types import MethodLU

    out = {"phase": "gesv_rbt"}
    for name, n in RBT_N:
        dtype = getattr(torch, name)
        gen = torch.Generator(device="cuda")
        aw = uniform((SLICE7B_WARMUP_N,) * 2, dtype, SEED + 310, torch)
        rbt.gesv_rbt_array(aw, aw[:, :NRHS].clone(), generator=gen.manual_seed(SEED))
        del aw
        a = uniform((n, n), dtype, SEED + 311, torch)
        b = randn((n, NRHS), dtype, SEED + 312, torch)
        reset_counts(kernels)
        (x, f), seconds, peak = timed_solve(
            lambda: rbt.gesv_rbt_array(a, b, generator=gen.manual_seed(SEED + 313)), torch)
        launched = hand_launches(kernels)
        e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
        w, w_gate = omega(a, x, b, torch), omega_gate(n, dtype, torch)
        b2 = randn((n, NRHS), dtype, SEED + 314, torch)
        e2 = eta(a, f.solve(b2), b2, torch)
        (xn, fn), nopiv_seconds, nopiv_peak = timed_solve(
            lambda: lu.gesv_array(a, b, MethodLU.NoPiv), torch)
        out[name] = {"n": n, "npad": f.npad, "depth": f.ud.shape[0], "info": int(f.info), "eta": e,
                     "eta_gate": gate, "omega": w, "omega_reading_line": w_gate,
                     "omega_over_line": w / w_gate, "seconds": seconds, "peak_mem_bytes": peak,
                     "hand_kernel_launches": launched, "factors_solve_eta": e2,
                     "nopiv": {"seconds": nopiv_seconds, "peak_mem_bytes": nopiv_peak,
                               "info": int(fn.info),
                               "eta": eta(a, xn, b, torch), "omega": omega(a, xn, b, torch),
                               "x_finite": bool(torch.isfinite(xn).all())}}
        check(int(f.info) == 0, f"gesv_rbt {name}: info {int(f.info)}")
        check(tuple(x.shape) == (n, NRHS) and bool(torch.isfinite(x).all()), f"gesv_rbt {name}: bad X")
        check(e < gate, f"gesv_rbt {name}: eta {e} >= {gate}")
        check(e2 < gate, f"gesv_rbt {name}: RBTFactors.solve eta {e2} >= {gate}")
        check(not launched, f"gesv_rbt {name}: hand kernels launched {launched}")
        del a, b, b2, x, f, xn, fn
        torch.cuda.empty_cache()
    n, dtype = RBT_ZERO_N, torch.float64
    a = uniform((n, n), dtype, SEED + 315, torch)
    a[0, 0] = 0
    b = randn((n, NRHS), dtype, SEED + 316, torch)
    xn, fn = lu.gesv_array(a, b, MethodLU.NoPiv)
    x, f = rbt.gesv_rbt_array(a, b, generator=torch.Generator(device="cuda").manual_seed(SEED + 317))
    e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
    nopiv_failed = int(fn.info) != 0 or not bool(torch.isfinite(xn).all())
    out["zero_a00_float64"] = {"n": n, "nopiv_info": int(fn.info),
                               "nopiv_x_finite": bool(torch.isfinite(xn).all()),
                               "rbt_info": int(f.info), "rbt_eta": e, "eta_gate": gate,
                               "rbt_omega": omega(a, x, b, torch)}
    emit(out)
    check(nopiv_failed, "gesv_rbt: NoPiv solved A[0, 0] = 0 without a sign of the zero pivot")
    check(int(f.info) == 0 and e < gate, f"gesv_rbt A[0, 0] = 0: info {int(f.info)}, eta {e}")
    del a, b, x, f, xn, fn
    torch.cuda.empty_cache()


def nonuniform_sizes(n):
    """NONUNIFORM_CYCLE repeated to n, the last size trimmed."""
    sizes = []
    while sum(sizes) < n:
        sizes.append(NONUNIFORM_CYCLE[len(sizes) % len(NONUNIFORM_CYCLE)])
    sizes[-1] -= sum(sizes) - n
    return sizes


def redistribute_mesh_phase(kernels, mp, bucket_plan, torch):
    """redistribute, f32 n = 16384 at nb = 256 off the virtual 2 x 4 mesh:
    to 4 x 2 under eager and under shardmap (the ring), bitwise equal, the
    ring's audited bytes equal redistribute_wire_bytes, seconds and the
    moved bytes' rate (each byte of the stack read and written once)
    against 3.35 TB/s; to 1 x 8 with diag_pad at n = 15260 (60 tiles grow
    to 64), the four fresh pad tiles the identity under both lowerings; an
    nb change 256 -> 512 and back, bitwise.  Then the non-uniform tiling at
    f32 n = 8192, tile sizes cycling (256, 128, 192): the round trip
    bitwise, gemm_summa of two non-uniform operands within product_ratio
    of the f64 product, and redistribute_nonuniform(nb = 256,
    diag_pad_one) -> potrf_dist -> two trsm_dist: info 0, eta < 100 n eps,
    chol_panel_tiles / chol_trailing_update launches derived by
    expected_potrf_launches.  Each timed call follows a warm-up at
    n = 256 and has its peak memory read.  Returns the non-uniform paths'
    launches."""
    from slate_tpu_torch.core.tiling import from_cyclic
    from slate_tpu_torch.parallel import comm, dist
    from slate_tpu_torch.types import Diag, MethodGemm, Op, Uplo, select_gemm_method

    dtype = torch.float32
    m24, m42, m18 = (mp.make_mesh(p, q, device="cuda") for p, q in ((P, Q), (Q, P), (1, P * Q)))
    out = {"phase": "redistribute_mesh", "nb": NB}
    w = mp.from_dense(randn((SLICE7B_WARMUP_N,) * 2, dtype, SEED + 320, torch), m24, NB)
    for impl in ("eager", "shardmap"):
        mp.redistribute(w, m42, impl=impl)
    mp.redistribute(mp.redistribute(w, m42, nb=2 * NB), m24, nb=NB)
    del w

    peaks = {}

    def run(fn, label=None):
        """fn()'s result, seconds and audited bytes; its peak memory under
        ``label``."""
        torch.cuda.reset_peak_memory_stats()
        with comm.comm_audit() as recs:
            res, seconds = timed(fn, torch)
        if label:
            peaks[label] = torch.cuda.max_memory_allocated()
        return res, seconds, sum(nbytes * mult for _, nbytes, mult in recs)

    n = REDIST_N
    d = mp.from_dense(randn((n, n), dtype, SEED + 321, torch), m24, NB)
    stack = d.tiles.numel() * d.tiles.element_size()
    te, e_s, e_wire = run(lambda: mp.redistribute(d, m42, impl="eager"), "to_4x2_eager")
    ts, s_s, s_wire = run(lambda: mp.redistribute(d, m42, impl="shardmap"), "to_4x2_shardmap")
    want_wire = dist.redistribute_wire_bytes(d.tiles.shape, P, Q, d.tiles.element_size())
    same = bool(torch.equal(te.tiles, ts.tiles)) and (te.m, te.n, te.nb, te.diag_pad) == (
        ts.m, ts.n, ts.nb, ts.diag_pad)
    out["to_4x2"] = {"n": n, "stack_bytes": stack, "bitwise": same,
                     "eager": {"seconds": e_s, "audited_bytes": e_wire,
                               "rate_of_peak": 2 * stack / e_s / PEAK_BYTES_S},
                     "shardmap": {"seconds": s_s, "audited_bytes": s_wire,
                                  "wire_bytes_formula": want_wire,
                                  "rate_of_peak": 2 * stack / s_s / PEAK_BYTES_S}}
    check(same, "redistribute 2x4 -> 4x2: eager and shardmap differ")
    check(s_wire == want_wire and e_wire == 0,
          f"redistribute 2x4 -> 4x2: audited {s_wire} / {e_wire} bytes, formula {want_wire}")
    del te, ts
    r2, r_s, _ = run(lambda: mp.redistribute(d, m42, nb=2 * NB), "nb_to_512")
    r3, b_s, _ = run(lambda: mp.redistribute(r2, m24, nb=NB), "nb_to_256")
    out["nb_256_512_256"] = {"seconds": [r_s, b_s], "bitwise": bool(torch.equal(r3.tiles, d.tiles))}
    check(out["nb_256_512_256"]["bitwise"], "redistribute nb 256 -> 512 -> 256: not bitwise")
    del d, r2, r3
    torch.cuda.empty_cache()
    n = REDIST_PAD_N
    d = mp.from_dense(randn((n, n), dtype, SEED + 322, torch), m24, NB, diag_pad_one=True)
    grown = {}
    for impl in ("eager", "shardmap"):
        g, seconds, _ = run(lambda: mp.redistribute(d, m18, impl=impl), f"to_1x8_{impl}")
        logi = from_cyclic(g.tiles, 1, P * Q)
        eye = torch.eye(NB, dtype=dtype, device="cuda")
        fresh = list(range(d.mt, g.mt))
        grown[impl] = {"seconds": seconds, "tiles": [d.mt, g.mt], "diag_pad": g.diag_pad,
                       "fresh_identity": all(bool(torch.equal(logi[t, t], eye)) for t in fresh)}
        check(g.diag_pad and fresh == [60, 61, 62, 63] and grown[impl]["fresh_identity"],
              f"redistribute 2x4 -> 1x8 ({impl}): {grown[impl]}")
        grown[impl]["result"] = g
    same = bool(torch.equal(grown["eager"].pop("result").tiles, grown["shardmap"].pop("result").tiles))
    out["to_1x8_diag_pad"] = {"n": n, "bitwise": same, **grown}
    check(same, "redistribute 2x4 -> 1x8: eager and shardmap differ")
    del d, logi
    torch.cuda.empty_cache()
    # the non-uniform tiling
    n = NONUNIFORM_N
    sizes = nonuniform_sizes(n)
    a = dominant_spd(n, dtype, SEED + 323, torch)
    b = randn((n, NRHS), dtype, SEED + 324, torch)
    aw = dominant_spd(SLICE7B_WARMUP_N, dtype, SEED + 325, torch)
    ww = [SLICE7B_WARMUP_N // 2] * 2
    mp.to_dense_nonuniform(mp.redistribute_nonuniform(
        mp.from_dense_nonuniform(aw, m24, ww, ww), ww, ww, nb=NB, diag_pad_one=True), ww, ww)
    dn, f_s, _ = run(lambda: mp.from_dense_nonuniform(a, m24, sizes, sizes), "from_dense_nonuniform")
    back, t_s, _ = run(lambda: mp.to_dense_nonuniform(dn, sizes, sizes), "to_dense_nonuniform")
    nu = {"n": n, "tiles": len(sizes), "nb": dn.nb, "from_seconds": f_s, "to_seconds": t_s,
          "roundtrip_bitwise": bool(torch.equal(back, a))}
    check(nu["roundtrip_bitwise"] and dn.nb == max(NONUNIFORM_CYCLE), f"non-uniform round trip: {nu}")
    del back
    g1, g2 = randn((n, n), dtype, SEED + 326, torch), randn((n, n), dtype, SEED + 327, torch)
    ga, gb = mp.from_dense_nonuniform(g1, m24, sizes, sizes), mp.from_dense_nonuniform(g2, m24, sizes, sizes)
    method = select_gemm_method(ga.mt, gb.nt, ga.nt)
    mp.gemm_summa(1.0, mp.from_dense_nonuniform(aw, m24, ww, ww), mp.from_dense_nonuniform(aw, m24, ww, ww))
    reset_counts(kernels)
    c, g_s, _ = run(lambda: mp.gemm_summa(1.0, ga, gb), "nonuniform_gemm")
    gemm_launches = read_counts(kernels)["summa_update"]
    ratio = product_ratio(mp.to_dense_nonuniform(c, sizes, sizes), g1.double() @ g2.double(), n, 1,
                          torch.finfo(dtype).eps, float(g1.abs().max()), float(g2.abs().max()))
    want_gemm = ga.nt if method == MethodGemm.GemmC else None
    nu["gemm"] = {"seconds": g_s, "method": method.name, "err_over_tol": ratio,
                  "summa_update_launches": gemm_launches, "derived": want_gemm}
    check(ratio < 1, f"non-uniform gemm_summa: error {ratio} of product_ratio's bound")
    check(want_gemm is not None and gemm_launches == want_gemm,
          f"non-uniform gemm_summa ({method.name}): {gemm_launches} summa_update launches, "
          f"derived {want_gemm}")
    del g1, g2, ga, gb, c
    torch.cuda.empty_cache()

    def posv(dn, sizes, b):
        ad = mp.redistribute_nonuniform(dn, sizes, sizes, nb=NB, diag_pad_one=True)
        l, info = mp.potrf_dist(ad, overwrite_a=True)
        bd = mp.from_dense(b, m24, NB)
        y = mp.trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, Diag.NonUnit)
        x = mp.trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, Diag.NonUnit)
        return mp.to_dense(x), info, ad.nt

    posv(mp.from_dense_nonuniform(aw, m24, ww, ww), ww, aw[:, :NRHS].clone())  # the warm-up
    torch.cuda.empty_cache()
    reset_counts(kernels)
    (x, info, nt), p_s, _ = run(lambda: posv(dn, sizes, b), "nonuniform_posv")
    counts = read_counts(kernels)
    want = expected_potrf_launches(nt, 1, bucket_plan)
    e, gate = eta(a, x, b, torch), 100 * n * torch.finfo(dtype).eps
    nu["posv"] = {"seconds": p_s, "info": int(info), "eta": e, "eta_gate": gate,
                  "launches": {k: counts[k] for k in want}, "derived": want}
    out["nonuniform"] = nu
    out["peak_mem_bytes"] = peaks
    emit(out)
    check(int(info) == 0 and e < gate, f"non-uniform posv: info {int(info)}, eta {e} (gate {gate})")
    for k, v in want.items():
        check(counts[k] == v, f"non-uniform posv: {counts[k]} {k} launches, derived {v}")
    del a, b, x, dn, aw
    torch.cuda.empty_cache()
    return {"summa_update": gemm_launches, **{k: counts[k] for k in want}}


# slice 9b: checkpoint and restart on the virtual 2 x 4 mesh at nb = 256.
# Each (op, size, every) runs the plain driver, the checkpointed chain, a
# seeded kill in the second segment with its resumes, and the op's own
# checks; the phase's seconds are held to CKPT_BUDGET_S.  The pp loop is a
# host-bound column loop (~0.26 s a step of 256 columns on the H100's
# host): at pp 2048 the phase read 22.5 s (pp 7.24 s of it; the potrf and
# nopiv resumes' host permutation, 1.6-1.9 s each, has since moved to the
# card), so pp is cut to 1024 (4 steps: its second segment is step 3).
CKPT_CASES = (("potrf", (16384, 16384), 16), ("getrf_nopiv", (16384, 16384), 16),
              ("getrf_pp", (1024, 1024), 3), ("geqrf", (8192, 4096), 4),
              ("he2hb", (4096, 4096), 4))
CKPT_WARMUP_N = 1024
CKPT_SEED = 90
CKPT_BUDGET_S = 15.0


def expected_ckpt_launches(op, steps):
    """Launches of a checkpointed chain's ``steps`` steps, derived from its
    segments: every step runs in the strict schedule (lookahead 0), so it
    has one panel launch and, for potrf and the no-pivot LU, one whole
    trailing update (no narrow refresh, no drain); pp solves its panel row
    only (its update is pinned to the matmul form); geqrf factors the owning
    column's p panels in one offset launch and merges them in p - 1;
    he2hb factors one replicated panel a step."""
    return {"potrf": {"chol_panel_tiles": steps, "chol_trailing_update": steps},
            "getrf_nopiv": {"lu_panel_tiles": steps, "lu_rowsolve_tiles": steps,
                            "lu_trailing_update": steps},
            "getrf_pp": {"lu_rowsolve_tiles": steps},
            "geqrf": {"qr_panel_offset": steps, "qr_panel": steps * (P - 1)},
            "he2hb": {"qr_panel_offset": steps}}[op]


def ckpt_operand(op, shape, seed, mesh, mp, torch):
    """(dense A, its DistMatrix) for ``op``: SPD, uniform[-1, 1) + n I,
    uniform[-1, 1), Gaussian, symmetric Gaussian."""
    m, n = shape
    dtype = torch.float32
    if op == "potrf":
        a = dominant_spd(n, dtype, seed, torch)
    elif op in ("getrf_nopiv", "getrf_pp"):
        a = lu_matrix("nopiv" if op == "getrf_nopiv" else "pp", n, dtype, seed, torch)
    elif op == "geqrf":
        a = randn((m, n), dtype, seed, torch)
    else:
        a = sym_operand(n, dtype, seed, torch)
    return a, mp.from_dense(a, mesh, NB, diag_pad_one=op in ("potrf", "getrf_nopiv", "getrf_pp"))


def ckpt_bitwise(ref, got, torch):
    from slate_tpu_torch.ft.ckpt_smoke import result_tensors

    return all(torch.equal(r, g) for r, g in zip(result_tensors(ref), result_tensors(got)))


def ckpt_solve_eta(op, a, fac, mp, mesh, torch):
    """eta of the factor's solve (two trsm_dist sweeps; pp permutes B
    first) on 32 Gaussian right-hand sides."""
    from slate_tpu_torch.types import Diag, Op, Uplo

    n = a.shape[0]
    b = randn((n, NRHS), a.dtype, SEED + 95, torch)
    bd = mp.from_dense(b, mesh, NB)
    f = fac[0]
    if op == "potrf":
        y = mp.trsm_dist(f, bd, Uplo.Lower, Op.NoTrans)
        x = mp.trsm_dist(f, y, Uplo.Lower, Op.ConjTrans)
    else:
        if op == "getrf_pp":
            bd = mp.permute_rows_dist(bd, fac[1])
        y = mp.trsm_dist(f, bd, Uplo.Lower, Op.NoTrans, Diag.Unit)
        x = mp.trsm_dist(f, y, Uplo.Upper, Op.NoTrans)
    return eta(a, mp.to_dense(x), b, torch)


def ckpt_snapshot_rates(op, d, every, torch):
    """One sync and one async snapshot of ``op``'s carry over ``d`` (the
    functions the chain calls at a boundary), timed alone: seconds and
    GB/s to the host; for the async one the host's time to issue it (the
    device clone and the copy's launch, no device sync) beside the time
    from issue to its fence; the two snapshots bitwise."""
    import numpy as np
    from slate_tpu_torch.ft import ckpt

    st = ckpt._carry_init(op, d)
    args = (op, d, st, every, every, "auto", "auto")
    sync, s_sec = timed(lambda: ckpt._snapshot(*args), torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pend = ckpt._PendingSnapshot(*args, False, True)
    issue_sec = time.perf_counter() - t0
    asnap = pend.wait()
    total_sec = time.perf_counter() - t0
    same = all(np.array_equal(x, y) for x, y in
               [(sync.tiles, asnap.tiles)] + [(sync.arrays[k], asnap.arrays[k]) for k in sync.arrays])
    nbytes = sync.nbytes
    return {"bytes": nbytes, "sync_seconds": s_sec, "sync_gb_s": nbytes / s_sec / 1e9,
            "async_issue_seconds": issue_sec, "async_issue_to_fence_seconds": total_sec,
            "async_gb_s": nbytes / total_sec / 1e9, "bitwise": same}


def ckpt_kill(op, fn, k, in_segment=False):
    from slate_tpu_torch.ft import ckpt, inject

    try:
        with inject.fault_scope(inject.FaultPlan([inject.KillFault(op, k, in_segment=in_segment)])):
            fn()
    except ckpt.Preempted as e:
        return e.checkpoint
    fail(f"ckpt {op}: no Preempted at an armed kill at step {k}")


def ckpt_counts_add(a, b):
    return {k: a[k] + b[k] for k in a}


def ckpt_op_phase(op, shape, every, kernels, mp, m24, m42, torch):
    """One op's checks on the card: the chain bitwise the plain driver with
    its launches derived; a seeded kill in the second segment and the
    same-mesh resume bitwise, the kill + resume launches the chain's; for
    the tile-stack ops the 2 x 4 -> 4 x 2 resume bitwise with the ring's
    audited bytes ``redistribute_wire_bytes``, for the multi-array ops its
    refusal; potrf's in-segment kill (lost steps exact, launches the
    chain's plus the re-run steps') and async snapshots (bitwise the sync
    ones); pp's disk round trip; info 0 and eta < 100 n eps for the
    factors' solves; snapshot rates, seconds and peak memory."""
    import tempfile
    from slate_tpu_torch.ft import ckpt, elastic, inject
    from slate_tpu_torch.ft.policy import ft_counter_values
    from slate_tpu_torch.linalg.eig import _he2hb_panel_count
    from slate_tpu_torch.parallel import comm
    from slate_tpu_torch.types import SlateError

    plain = {"potrf": mp.potrf_dist, "getrf_nopiv": mp.getrf_nopiv_dist,
             "getrf_pp": mp.getrf_pp_dist, "geqrf": mp.geqrf_dist, "he2hb": mp.he2hb_dist}[op]
    chained = getattr(ckpt, f"{op}_ckpt")
    m, n = shape
    a, d = ckpt_operand(op, shape, CKPT_SEED + len(op), m24, mp, torch)
    steps = _he2hb_panel_count(n, NB) if op == "he2hb" else d.nt
    want = expected_ckpt_launches(op, steps)
    out = {"phase": f"ckpt_mesh_{op}", "m": m, "n": n, "nb": NB, "grid": [P, Q], "every": every,
           "steps": steps}
    multi = op in ("geqrf", "he2hb")

    def counted(fn):
        reset_counts(kernels)
        res, seconds = timed(fn, torch)
        return res, seconds, {k: read_counts(kernels)[k] for k in want}

    ref, out["plain_seconds"] = timed(lambda: plain(d), torch)
    c0 = ft_counter_values()
    got, out["chain_seconds"], chain_counts = counted(lambda: chained(d, every=every))
    c1 = ft_counter_values()
    out["chain_overhead"] = out["chain_seconds"] / out["plain_seconds"] - 1
    out["chain_snapshots"] = c1["ckpt_snapshots"] - c0["ckpt_snapshots"]
    out["chain_snapshot_bytes"] = c1["ckpt_snapshot_bytes"] - c0["ckpt_snapshot_bytes"]
    out["launches"], out["derived"] = chain_counts, want
    out["chain_bitwise"] = ckpt_bitwise(ref, got, torch)
    check(out["chain_bitwise"], f"ckpt {op}: the chain is not bitwise the plain driver")
    check(chain_counts == want, f"ckpt {op}: chain launches {chain_counts}, derived {want}")
    check(out["chain_snapshots"] == (steps - 1) // every,
          f"ckpt {op}: {out['chain_snapshots']} snapshots for {steps} steps every {every}")
    del got
    torch.cuda.empty_cache()

    # a seeded kill in the second segment, then the same-mesh resume
    kill_k = every + inject.seeded_kill(CKPT_SEED + steps, op, steps).k % min(every, steps - every)
    c0 = ft_counter_values()
    ck, kill_s, kill_counts = counted(lambda: ckpt_kill(op, lambda: chained(d, every=every), kill_k))
    c1 = ft_counter_values()
    out["kill"] = {"k": kill_k, "snapshot_step": ck.step, "seconds": kill_s,
                   "lost_steps": c1["ckpt_lost_steps"] - c0["ckpt_lost_steps"]}
    check(ck.step == every and out["kill"]["lost_steps"] == kill_k - every,
          f"ckpt {op}: kill {out['kill']}")
    if op == "getrf_pp":
        # the disk round trip (the carry is 4 MiB here): the same-mesh
        # resume reads the snapshot back from a temporary file
        with tempfile.TemporaryDirectory() as td:
            path = ck.save(f"{td}/ck.npz")
            out["disk_bytes"] = os.path.getsize(path)
            ck = ckpt.Checkpoint.load(path)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res, out["resume_seconds"], res_counts = counted(lambda: elastic.resume(ck, m24))
    out["resume_peak_bytes"] = torch.cuda.max_memory_allocated() - before
    out["resume_bitwise"] = ckpt_bitwise(ref, res, torch)
    out["kill_resume_launches"] = ckpt_counts_add(kill_counts, res_counts)
    check(out["resume_bitwise"], f"ckpt {op}: the same-mesh resume is not bitwise")
    check(out["kill_resume_launches"] == want,
          f"ckpt {op}: kill + resume launches {out['kill_resume_launches']}, derived {want}")

    if multi:
        try:
            elastic.resume(ck, m42)
            refused = False
        except SlateError:
            refused = True
        out["reshaped_refused"] = refused
        check(refused, f"ckpt {op}: a 4 x 2 resume of a grid-locked carry was not refused")
    else:
        reset_counts(kernels)
        with comm.comm_audit() as recs:  # psum lowering: the ring's are the only hops
            res2, r2_s = timed(lambda: elastic.resume(ck, m42, bcast_impl="psum"), torch)
        r2_counts = {k: read_counts(kernels)[k] for k in want}
        ring = sum(b * mult for name, b, mult in recs if name.startswith("ppermute"))
        wire = mp.redistribute_wire_bytes(d.tiles.shape, P, Q, d.tiles.element_size())
        same = bool(torch.equal(mp.to_dense(ref[0]), mp.to_dense(res2[0])))
        out["reshaped"] = {"seconds": r2_s, "bitwise": same, "ring_audited_bytes": ring,
                           "wire_bytes_formula": wire,
                           "kill_resume_launches": ckpt_counts_add(kill_counts, r2_counts)}
        check(same, f"ckpt {op}: the 2 x 4 -> 4 x 2 resume is not bitwise")
        check(ring == wire, f"ckpt {op}: ring audited {ring} bytes, formula {wire}")
        check(out["reshaped"]["kill_resume_launches"] == want,
              f"ckpt {op}: 4 x 2 kill + resume launches {out['reshaped']}")
        if op == "getrf_pp":
            out["reshaped"]["perm_bitwise"] = bool(torch.equal(ref[1][:n], res2[1][:n]))
            check(out["reshaped"]["perm_bitwise"], "ckpt getrf_pp: the 4 x 2 perm differs")
        del res2
        info = int(ref[-1])
        e, gate = ckpt_solve_eta(op, a, res, mp, m24, torch), 100 * n * torch.finfo(a.dtype).eps
        out.update(info=info, eta=e, eta_gate=gate)
        check(info == 0 and int(res[-1]) == 0, f"ckpt {op}: info {info} / {int(res[-1])}")
        check(e < gate, f"ckpt {op}: eta {e} >= {gate}")
    del res
    torch.cuda.empty_cache()

    if op == "potrf":
        # an in-segment kill: the partial segment runs, then is lost
        k_in = every + 1 + (kill_k % (every - 1))
        c0 = ft_counter_values()
        ck_in, _, in_counts = counted(
            lambda: ckpt_kill(op, lambda: chained(d, every=every), k_in, in_segment=True))
        c1 = ft_counter_values()
        lost = c1["ckpt_lost_steps"] - c0["ckpt_lost_steps"]
        res_in, _, rin_counts = counted(lambda: elastic.resume(ck_in, m24))
        rerun = {k: v + (k_in - every) for k, v in want.items()}
        out["in_segment"] = {"k": k_in, "snapshot_step": ck_in.step, "lost_steps": lost,
                             "inseg_kills": c1["ckpt_inseg_kills"] - c0["ckpt_inseg_kills"],
                             "bitwise": ckpt_bitwise(ref, res_in, torch),
                             "launches": ckpt_counts_add(in_counts, rin_counts), "derived": rerun}
        check(lost == k_in - ck_in.step and out["in_segment"]["inseg_kills"] == 1
              and out["in_segment"]["bitwise"] and out["in_segment"]["launches"] == rerun,
              f"ckpt potrf in-segment kill: {out['in_segment']}")
        del res_in, ck_in
        # async snapshots: the chain bitwise, the killed run's snapshot
        # bitwise the sync one
        c0 = ft_counter_values()
        ga, a_s = timed(lambda: chained(d, every=every, async_snapshots=True), torch)
        c1 = ft_counter_values()
        ck_a = ckpt_kill(op, lambda: chained(d, every=every, async_snapshots=True), kill_k)
        out["async"] = {"chain_seconds": a_s, "bitwise": ckpt_bitwise(ref, ga, torch),
                        "async_snapshots": c1["ckpt_async_snapshots"] - c0["ckpt_async_snapshots"],
                        "overlap_s": c1["ckpt_async_overlap_s"] - c0["ckpt_async_overlap_s"],
                        "snapshot_bitwise": bool((ck_a.tiles == ck.tiles).all())
                        and ck_a.step == ck.step}
        check(out["async"]["bitwise"] and out["async"]["snapshot_bitwise"]
              and out["async"]["async_snapshots"] == (steps - 1) // every,
              f"ckpt potrf async: {out['async']}")
        del ga, ck_a
    del ck, ref
    torch.cuda.empty_cache()
    out["snapshot"] = ckpt_snapshot_rates(op, d, every, torch)
    check(out["snapshot"]["bitwise"], f"ckpt {op}: async snapshot differs from sync")
    del a, d
    torch.cuda.empty_cache()
    emit(out)
    return chain_counts


def ckpt_mesh_phase(kernels, mp, smi_line, torch):
    """Slice 9b on the card: ckpt_op_phase for every (op, size, every) of
    CKPT_CASES after a warm-up chain (sync and async) at n = 1024; returns
    the chains' launches and the phase's seconds per op."""
    from slate_tpu_torch.ft import ckpt

    m24, m42 = mp.make_mesh(P, Q, device="cuda"), mp.make_mesh(Q, P, device="cuda")
    seconds = {}
    t0 = time.perf_counter()
    w = mp.from_dense(dominant_spd(CKPT_WARMUP_N, torch.float32, CKPT_SEED, torch), m24, NB,
                      diag_pad_one=True)
    for asnap in (False, True):
        ckpt.potrf_ckpt(w, every=1, async_snapshots=asnap)  # pinned buffers, the side stream
    del w
    seconds["warmup"] = time.perf_counter() - t0
    launches = {}
    for op, shape, every in CKPT_CASES:
        t0 = time.perf_counter()
        launches[op] = ckpt_op_phase(op, shape, every, kernels, mp, m24, m42, torch)
        seconds[op] = time.perf_counter() - t0
    emit({"phase": "slice9b_seconds", **seconds, "sum": sum(seconds.values()),
          "budget": CKPT_BUDGET_S, "card": smi_line})
    # the checkpoint smoke, its RunReport and --check on the card
    from slate_tpu_torch.ft import ckpt_smoke

    t0 = time.perf_counter()
    res = ckpt_smoke.run_smoke("cuda")
    emit({"phase": "ckpt_smoke", "seconds": time.perf_counter() - t0,
          **{k: res[k] for k in ("ok", "checks", "failures", "counters")}})
    check(res["ok"] and res["checks"].get("report") and res["checks"].get("report-ft"),
          f"ckpt smoke failed: {res['failures']}")
    return launches


# slice 10a: the observability core on the virtual 2 x 4 mesh at nb = 256.
# The instrumented posv_mesh (f32, the mesh posv's size) beside its obs-off
# run, then one flight per mesh k-loop: potrf at full width, the others at
# the sizes of the checkpoint phase, each at lookahead 1 (the strict chains
# at 0).  The phase's seconds are held to OBS_BUDGET_S.
OBS_POSV_N = 32768
OBS_FLIGHTS = (("potrf", 32768, None), ("summa", 8192, None), ("getrf_nopiv", 8192, None),
               ("trsm", 8192, None), ("geqrf", 4096, 8192), ("he2hb", 4096, None))
OBS_COLS = 64  # the flights' residuals read 64 evenly spaced columns
OBS_SEED = 200
OBS_BUDGET_S = 20.0
OBS_TREE = [("potrf_dist", "potrf_mesh", 2), ("potrf_mesh", "posv_mesh", 1),
            ("trsm_dist", "posv_mesh", 1), ("trsm_dist", "posv_mesh", 1),
            ("posv_mesh", None, 0), ("gemm_summa", None, 0)]


def expected_flight_rows(op, nt, la):
    """Rows of one flight, derived from its loop: summa a fetch and an
    update a step; the factor loops a panel and its broadcast a step plus,
    at lookahead 0, one update a step, at lookahead 1 two deferred halves a
    step after the first and the drain (a bucket's drain and the next
    bucket's first narrow update are one row); trsm, geqrf and he2hb three
    phases a step."""
    if op == "summa":
        return 2 * nt
    if op in ("potrf", "getrf_nopiv"):
        return 3 * nt if la == 0 else 4 * nt - 1
    return 3 * nt


def expected_flight_launches(op, nt, la, bucket_plan):
    """Hand-kernel launches of one flown run (the plain driver's own loop):
    summa one update a step; potrf and the no-pivot LU their drivers';
    trsm none (its solves and update are torch ops); geqrf one offset panel
    and p - 1 merges a step; he2hb one offset panel a step."""
    if op == "summa":
        return {"summa_update": nt}
    if op == "potrf":
        return expected_potrf_launches(nt, la, bucket_plan)
    if op == "getrf_nopiv":
        return expected_lu_launches("nopiv", nt, la, bucket_plan)
    if op == "geqrf":
        return {"qr_panel_offset": nt, "qr_panel": nt * (P - 1)}
    if op == "he2hb":
        return {"qr_panel_offset": nt}
    return {}


def profiler_start(torch):
    """torch.profiler's one-time start-up in the process (8.3 s on the
    chip machine's host), paid beside the build: the obs phase's profiled
    call then costs its own time.  Returns the seconds it took."""
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pass
    return time.perf_counter() - t0


def spans_of(finished):
    return [(s["name"], s["parent"], s["depth"]) for s in finished]


def obs_phase(kernels, mp, bucket_plan, smi_line, torch):
    """Slice 10a on the card: the instrumented posv_mesh and its gemm_summa
    residual (X and R bitwise the obs-off run, the span tree, each span's
    comm bytes against a comm audit of the same call, seconds on and off,
    the launches), the six flights (each result bitwise its plain driver,
    the rows and launches derived from the loops, the overlap gates, the
    model's bytes against the audit, the report valid), one instrumented
    call under torch.profiler, the obs smoke and a flight Gantt.  Returns
    (the flights' launches by op, the instrumented posv's launches)."""
    from slate_tpu_torch import obs
    from slate_tpu_torch.obs import flight, perfetto, smoke
    from slate_tpu_torch.parallel import comm

    dtype, n = torch.float32, OBS_POSV_N
    gate = 100 * n * float(torch.finfo(dtype).eps)
    mesh = mp.make_mesh(P, Q, device="cuda")
    secs = {}
    t_phase = time.perf_counter()

    # warm-up: the instrumented chain and a flight at small sizes
    t0 = time.perf_counter()
    aw = dominant_spd(2048, dtype, OBS_SEED, torch)
    bw = randn((2048, NRHS), dtype, OBS_SEED + 1, torch)
    with obs.force_enabled():
        mp.posv_mesh(aw, bw, mesh, NB)
    flight.run_flight("potrf", n=2048, nb=NB, depth=1, mesh=mesh, gen="torch", cols=OBS_COLS)
    obs.reset()
    del aw, bw
    torch.cuda.synchronize()
    secs["warmup"] = time.perf_counter() - t0

    # 1. posv_mesh and its residual, obs off then on
    t0 = time.perf_counter()
    a = dominant_spd(n, dtype, OBS_SEED + 2, torch)
    b = randn((n, NRHS), dtype, OBS_SEED + 3, torch)
    ad = mp.from_dense(a, mesh, NB)
    torch.cuda.synchronize()
    reset_counts(kernels)
    with comm.comm_audit() as posv_recs:
        t1 = time.perf_counter()
        x_off, info = mp.posv_mesh(a, b, mesh, NB)
        torch.cuda.synchronize()
        posv_off = time.perf_counter() - t1
    off_counts = {k: v for k, v in read_counts(kernels).items() if v}
    with comm.comm_audit() as gemm_recs:
        t1 = time.perf_counter()
        r_off = mp.gemm_summa(1.0, ad, mp.from_dense(x_off, mesh, NB)).tiles
        torch.cuda.synchronize()
        gemm_off = time.perf_counter() - t1
    obs.reset()
    obs.enable()
    try:
        reset_counts(kernels)
        t1 = time.perf_counter()
        x_on, info_on = mp.posv_mesh(a, b, mesh, NB)
        posv_on = time.perf_counter() - t1
        posv_counts = {k: v for k, v in read_counts(kernels).items() if v}
        t1 = time.perf_counter()
        r_on = mp.gemm_summa(1.0, ad, mp.from_dense(x_on, mesh, NB)).tiles
        gemm_on = time.perf_counter() - t1
    finally:
        obs.disable()
    spans = list(obs.FINISHED)
    by_name = {s["name"]: s for s in spans}
    audit = {"posv_mesh": sum(nb * m for _, nb, m in posv_recs),
             "gemm_summa": sum(nb * m for _, nb, m in gemm_recs)}
    rd = mp.to_dense(mp.DistMatrix(tiles=r_on, m=n, n=NRHS, nb=NB, mesh=mesh))
    e = float((rd - b).abs().max() / (a.abs().max() * x_on.abs().max() * n + b.abs().max()))
    nt = -(-n // NB)
    want = expected_potrf_launches(nt, 1, bucket_plan)
    secs["posv"] = time.perf_counter() - t0
    emit({"phase": "obs_posv", "n": n, "nb": NB, "mesh": [P, Q], "info": int(info_on), "eta": e,
          "posv_seconds_off": posv_off, "posv_seconds_on": posv_on,
          "gemm_seconds_off": gemm_off, "gemm_seconds_on": gemm_on,
          "spans": spans_of(spans), "comm_bytes": {k: by_name[k]["metrics"]["comm_bytes"]
                                                   for k in audit},
          "audited_bytes": audit, "launches": posv_counts, "launches_off": off_counts,
          "derived": want, "card": smi_line})
    check(int(info) == 0 and int(info_on) == 0 and e < gate, f"obs posv: info {int(info_on)} eta {e}")
    check(torch.equal(x_on, x_off) and torch.equal(r_on, r_off), "obs posv: X or R differs with obs on")
    check(spans_of(spans) == OBS_TREE, f"obs posv: span tree {spans_of(spans)}")
    for k, v in audit.items():
        check(by_name[k]["metrics"]["comm_bytes"] == v,
              f"obs posv: {k} span comm bytes {by_name[k]['metrics']['comm_bytes']} != audit {v}")
    check(posv_counts == want == off_counts,
          f"obs posv: launches {posv_counts} (obs off {off_counts}), derived {want}")
    del a, b, ad, x_off, x_on, r_off, r_on, rd
    torch.cuda.empty_cache()

    # 2. the flights
    launches = {}
    for i, (op, fn, fm) in enumerate(OBS_FLIGHTS):
        t0 = time.perf_counter()
        reset_counts(kernels)
        with comm.comm_audit() as recs:
            rep = flight.run_flight(op, n=fn, nb=NB, depth=1, mesh=mesh, m=fm, gen="torch",
                                    seed=OBS_SEED + 10 + i, cols=OBS_COLS)
        got = {k: v for k, v in read_counts(kernels).items() if v}
        seconds = time.perf_counter() - t0
        secs[f"flight_{op}"] = seconds
        cfg, sched = rep["config"], rep["sched"]
        la, nt = cfg["lookahead"], cfg["nt"]
        rows = len(rep["events"]) // (P * Q)
        # the driver runs: plain and flown at depth la and, for the
        # pipelined ops, the depth-0 contrast
        depths = (la, la) if op in ("geqrf", "he2hb") else (la, la, 0)
        want = {}
        for d in depths:
            for k, v in expected_flight_launches(op, nt, d, bucket_plan).items():
                want[k] = want.get(k, 0) + v
        runs = len(depths)
        audited = sum(nb * m for _, nb, m in recs)
        errs = flight.validate_flight_report(rep)
        emit({"phase": f"flight_{op}", "n": fn, "m": fm or fn, "nb": NB, "nt": nt, "lookahead": la,
              "seconds": seconds, "rows": rows, "derived_rows": expected_flight_rows(op, nt, la),
              "events": len(rep["events"]), "launches": got,
              "derived": want, "bitwise_plain": rep["bitwise_plain"],
              "sched": {k: sched[k] for k in ("critical_path_s", "overlap_eff", "overlap_eff_la0",
                                               "exposed_comm_s", "total_comm_s", "total_compute_s",
                                               "wall_s", "measured_bytes")},
              "model_bytes": rep["model"]["total_bytes"], "phase_bytes": rep["model"]["phase_bytes"],
              "audited_bytes": audited, "flops": sum(e["flops"] for e in rep["events"]),
              "resid": rep["values"]["resid"], "problems": errs, "card": smi_line})
        check(rep["bitwise_plain"], f"flight {op}: the flown result differs from the plain driver's")
        check(rows == expected_flight_rows(op, nt, la) and len(rep["events"]) == rows * P * Q,
              f"flight {op}: {rows} rows, derived {expected_flight_rows(op, nt, la)}")
        check(got == want, f"flight {op}: launches {got}, derived {want} over {runs} runs")
        if op in ("geqrf", "he2hb"):
            check(sched["overlap_eff"] == 0.0 == sched["overlap_eff_la0"],
                  f"flight {op}: strict overlap_eff {sched['overlap_eff']}")
        else:
            check(sched["overlap_eff_la0"] == 0.0 and 0.0 < sched["overlap_eff"] <= 1.0,
                  f"flight {op}: overlap_eff {sched['overlap_eff']} (la0 {sched['overlap_eff_la0']})")
        check(rep["model"]["total_bytes"] > 0
              and sched["measured_bytes"] == rep["model"]["total_bytes"]
              and audited == runs * rep["model"]["total_bytes"],
              f"flight {op}: model {rep['model']['total_bytes']} measured "
              f"{sched['measured_bytes']} audited {audited} over {runs} runs")
        check(not errs, f"flight {op}: report {errs}")
        check(rep["values"]["resid"] < gate, f"flight {op}: resid {rep['values']['resid']}")
        launches[op] = got
        if op == "potrf":
            tr = perfetto.flight_chrome_trace(rep["events"], rep["hop_events"], grid=(P, Q))
            terrs = perfetto.validate_chrome_trace(tr)
            check(not terrs and len({e["tid"] for e in tr["traceEvents"] if e["ph"] == "X"}) == P * Q,
                  f"flight potrf Gantt: {terrs[:4]}")
        del rep
        torch.cuda.empty_cache()

    # 3. the record_function bridge, 4. the obs smoke (its report and trace)
    t0 = time.perf_counter()
    small = mp.from_dense(dominant_spd(1024, dtype, OBS_SEED + 30, torch), mesh, NB,
                          diag_pad_one=True)
    # the host activity alone: record_function marks the host timeline, and
    # the CUDA activity's start-up took ~11 s in this phase's first run (the
    # host activity's one-time start-up runs beside the build)
    with obs.force_enabled():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            mp.potrf_dist(small)
            torch.cuda.synchronize()
    keys = {e.key for e in prof.key_averages()}
    res = smoke.run_smoke(device="cuda")
    obs.reset()
    secs["profiler_smoke"] = time.perf_counter() - t0
    emit({"phase": "obs_smoke", "profiler_has_span": "potrf_dist" in keys, **res})
    check("potrf_dist" in keys, "torch.profiler: no potrf_dist span (record_function bridge)")
    check(res["ok"], f"obs smoke failed: {res['failures']}")
    total = time.perf_counter() - t_phase
    emit({"phase": "slice10a_seconds", **secs, "sum": total, "budget": OBS_BUDGET_S,
          "within_budget": total <= OBS_BUDGET_S, "card": smi_line})
    return launches, posv_counts


# ---------------------------------------------------------------------------
# slice 10b: numerics and memory observability
# ---------------------------------------------------------------------------

# Option.NumMonitor on the card: posv_mesh f32 off then on, getrf_nopiv at
# lookahead 0 and 1, gels_mesh and he2hb_dist monitored (f64), the Wilkinson
# growth through getrf_mesh and the checkpointed nopiv chain's abort, a
# monitored potrf_ckpt kill -> resume, the health-routed f64 gesv_mesh;
# then memwatch potrf, a memory-sampled flight, the RunReport's sections
# and one OOM.  The phase's seconds are held to NUMMEM_BUDGET_S.
NUM_POSV_N = 16384
NUM_NOPIV_N = 8192
NUM_GELS_MN = (8192, 4096)
NUM_HE2HB_N = 4096
NUM_WILK_N, NUM_WILK_NB, NUM_WILK_EVERY = 64, 8, 2
NUM_CKPT_N, NUM_CKPT_EVERY, NUM_CKPT_KILL = 4096, 4, 8
# the routed gesv at 1024 with two GMRES restarts (Option.MaxIterations):
# its GMRES tier does not converge at cond 1e8 and the f64 fallback solves,
# as in slate_tpu, and each restart is 31 preconditioned residuals of eager
# mesh sweeps; at 2048 with the default 30 restarts it took 14.7 s on the
# chip machine, at 1024 8.7 s (n = 1024 pads to the same 4 tiles as any
# smaller n), over the phase's whole budget.  The route and the ir.*
# counters do not depend on the restart count
NUM_GESV_N, NUM_GESV_COND, NUM_GESV_RESTARTS = 1024, 1e8, 2
MEM_POTRF_N = 16384
MEM_FLIGHT_N = 2048
NUMMEM_SEED = 300
NUMMEM_BUDGET_S = 10.0


def wilkinson_abort_step(n, nb, every, threshold):
    """The segment boundary at which the monitored no-pivot chain must abort
    on the Wilkinson matrix: its running growth at step k's panel entry is
    2^(k nb) (the last column doubles each column; max|A| = 1), so the first
    step whose entry crosses ``threshold`` is the least k with 2^(k nb) >
    threshold, and the chain reads the gauge at the end of that step's
    segment."""
    nt = -(-n // nb)
    k = next(k for k in range(nt) if 2.0 ** (k * nb) > threshold)
    return min(-(-(k + 1) // every) * every, nt)


def obs_num_mem_phase(kernels, mp, smi_line, torch):
    """Slice 10b on the card (see the constants above).  Returns the
    launches of each monitored or traced path as [(path, dtype, {kernel:
    launches})], its paths named num_<op> / mem_<op> (the routed gesv's
    f32 factor under num_gesv too, at its own dtype)."""
    import numpy as np

    from slate_tpu_torch import obs
    from slate_tpu_torch.ft import ckpt, inject
    from slate_tpu_torch.linalg import refine
    from slate_tpu_torch.obs import memmodel, memory, memwatch, numerics, perfetto, report
    from slate_tpu_torch.parallel import comm
    from slate_tpu_torch.parallel.comm import bucket_plan
    from slate_tpu_torch.types import Option
    from slate_tpu_torch.utils.testing import generate

    f32, f64 = torch.float32, torch.float64
    mesh = mp.make_mesh(P, Q, device="cuda")
    on = {Option.NumMonitor: "on"}
    secs, paths, out = {}, {}, {"phase": "obs_num_mem", "card": smi_line}
    obs.reset()
    t_phase = time.perf_counter()

    def counted(path, dtype, fn):
        reset_counts(kernels)
        res = fn()
        torch.cuda.synchronize()
        paths[path] = (dtype, {k: v for k, v in read_counts(kernels).items() if v})
        return res

    # 1. posv_mesh off, then on: X bitwise, the same audited bytes, the
    # monitored launches derived from the loop, the margin, the monitor's cost
    t0 = time.perf_counter()
    n = NUM_POSV_N
    a = dominant_spd(n, f32, NUMMEM_SEED, torch)
    b = randn((n, NRHS), f32, NUMMEM_SEED + 1, torch)
    # off (its bits, and the allocator's first blocks at this size), on, then
    # off again: the monitor's cost reads against the second off run
    runs = {}
    for mode in ("off", "on", "off2"):
        torch.cuda.synchronize()
        with comm.comm_audit() as recs:
            t1 = time.perf_counter()
            x, info = counted("num_posv" if mode == "on" else "posv_" + mode, f32,
                              lambda: mp.posv_mesh(a, b, mesh, NB,
                                                   opts={Option.NumMonitor: mode[:3]}))
            runs[mode] = (x, int(info), time.perf_counter() - t1,
                          sum(nb * m for _, nb, m in recs))
        if mode == "on":
            g = numerics.last_gauges("potrf")
    # potrf_dist alone, off and on: the posv's difference less the exit
    # read's (the one host read ends the host's run-ahead into the sweeps)
    ad = mp.from_dense(a, mesh, NB, diag_pad_one=True)
    alone = {}
    for mode in ("off", "on", "off"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mp.potrf_dist(ad, num_monitor=mode)
        torch.cuda.synchronize()
        alone[mode] = time.perf_counter() - t1
    del ad
    nt = -(-n // NB)
    want = expected_potrf_launches(nt, 1, bucket_plan)
    out["posv"] = {"n": n, "seconds_off": runs["off2"][2], "seconds_on": runs["on"][2],
                   "seconds_first_off": runs["off"][2], "potrf_alone_seconds": alone,
                   "audited_bytes": [runs["off"][3], runs["on"][3]], "gauges": g,
                   "launches": paths["num_posv"][1], "derived": want}
    check(runs["on"][1] == runs["off"][1] == 0, f"num posv: info {runs['on'][1]}")
    check(torch.equal(runs["on"][0], runs["off"][0]), "num posv: X differs with NumMonitor on")
    check(runs["on"][3] == runs["off"][3], f"num posv: audited bytes {out['posv']['audited_bytes']}")
    check(paths["num_posv"][1] == want, f"num posv: launches {paths['num_posv'][1]}, derived {want}")
    check(math.isfinite(g.get("margin", math.nan)) and g["margin"] > 0, f"num posv: margin {g}")
    del a, b, runs, x
    secs["posv"] = time.perf_counter() - t0

    # 2. getrf_nopiv_mesh on at lookahead 0 and 1: the gauges bitwise each
    # other, the factor bitwise the off run's
    t0 = time.perf_counter()
    n = NUM_NOPIV_N
    a = lu_matrix("nopiv", n, f32, NUMMEM_SEED + 2, torch)
    lu_off, _ = mp.getrf_nopiv_mesh(a, mesh, NB)  # its bits, and the warm-up
    gz, secs_nopiv = {}, {"off": [], "on": []}
    for la in (0, 1, 1, 1):
        if la:  # lookahead 1: an unmonitored run beside each monitored one
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mp.getrf_nopiv_mesh(a, mesh, NB)
            torch.cuda.synchronize()
            secs_nopiv["off"].append(time.perf_counter() - t1)
        opts = {Option.NumMonitor: "on", Option.Lookahead: la}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lu_on, info = counted("num_getrf_nopiv" if la else "nopiv_la0", f32,
                              lambda: mp.getrf_nopiv_mesh(a, mesh, NB, opts=opts))
        if la:
            secs_nopiv["on"].append(time.perf_counter() - t1)
        gz[la] = numerics.last_gauges("getrf_nopiv")
        check(int(info) == 0 and torch.equal(lu_on.tiles, lu_off.tiles),
              f"num nopiv: la {la} factor differs from the unmonitored one")
    out["nopiv"] = {"n": n, "gauges": gz[1], "launches": paths["num_getrf_nopiv"][1],
                    "seconds_off": secs_nopiv["off"], "seconds_on": secs_nopiv["on"]}
    check(gz[0] == gz[1] and gz[1]["growth"] > 0, f"num nopiv: gauges {gz}")
    del a, lu_off, lu_on
    secs["nopiv"] = time.perf_counter() - t0

    # 3. gels_mesh and he2hb_dist in f64: the orthogonality gauges under
    # ORTH_THRESHOLD (1e-8, an f64 bound: an f32 panel's gauge reads ~1e-5
    # at m = 8192, its own eps class, and would always alarm)
    t0 = time.perf_counter()
    m, n = NUM_GELS_MN
    a = randn((m, n), f64, NUMMEM_SEED + 3, torch)
    b = randn((m, NRHS), f64, NUMMEM_SEED + 4, torch)
    counted("num_gels", f64, lambda: mp.gels_mesh(a, b, mesh, NB, opts=on))
    qr_loss = numerics.last_gauges("geqrf").get("qr_orth_loss")
    h = dominant_spd(NUM_HE2HB_N, f64, NUMMEM_SEED + 5, torch)
    counted("num_he2hb", f64, lambda: mp.he2hb_dist(mp.from_dense(h, mesh, NB), num_monitor="on"))
    he_loss = numerics.last_gauges("he2hb").get("he2hb_orth_loss")
    out["orth"] = {"gels_mn": [m, n], "qr_orth_loss": qr_loss, "he2hb_n": NUM_HE2HB_N,
                   "he2hb_orth_loss": he_loss, "threshold": numerics.ORTH_THRESHOLD}
    check(qr_loss is not None and 0 <= qr_loss < numerics.ORTH_THRESHOLD, f"num gels: {qr_loss}")
    check(he_loss is not None and 0 <= he_loss < numerics.ORTH_THRESHOLD, f"num he2hb: {he_loss}")
    del a, b, h
    secs["orth"] = time.perf_counter() - t0

    # 4. the Wilkinson growth: exactly 2^(n-1) through getrf_mesh, and the
    # monitored nopiv chain's GrowthAbort at the boundary the gauge predicts;
    # then a monitored potrf_ckpt kill -> resume, gauges bitwise the chain's
    t0 = time.perf_counter()
    n, nbw = NUM_WILK_N, NUM_WILK_NB
    w = torch.from_numpy(generate("wilkinson", n, dtype=np.float32)).cuda()
    counted("num_getrf", f32, lambda: mp.getrf_mesh(w, mesh, nbw, opts=on))
    growth = numerics.last_gauges("getrf_pp").get("growth")
    want_step = wilkinson_abort_step(n, nbw, NUM_WILK_EVERY, numerics.GROWTH_THRESHOLD)
    abort = None
    try:
        ckpt.getrf_nopiv_ckpt(mp.from_dense(w, mesh, nbw, diag_pad_one=True),
                              every=NUM_WILK_EVERY, num_monitor="on")
    except numerics.GrowthAbort as e:
        abort = (e.step, e.growth)
    out["wilkinson"] = {"n": n, "nb": nbw, "growth": growth, "abort": abort,
                        "abort_step_predicted": want_step}
    check(growth == 2.0 ** (n - 1), f"num wilkinson: growth {growth} != 2^{n - 1}")
    check(abort is not None and abort[0] == want_step,
          f"num wilkinson: GrowthAbort {abort}, predicted step {want_step}")
    n = NUM_CKPT_N
    d = mp.from_dense(dominant_spd(n, f32, NUMMEM_SEED + 6, torch), mesh, NB, diag_pad_one=True)
    counted("num_potrf_ckpt", f32,
            lambda: ckpt.potrf_ckpt(d, every=NUM_CKPT_EVERY, num_monitor="on"))
    chain = numerics.last_gauges("potrf")
    try:
        with inject.fault_scope(inject.FaultPlan([inject.KillFault("potrf", NUM_CKPT_KILL)])):
            ckpt.potrf_ckpt(d, every=NUM_CKPT_EVERY, num_monitor="on")
        snap = None
    except ckpt.Preempted as e:
        snap = e.checkpoint
    numerics.clear_last("potrf")
    from slate_tpu_torch.ft import elastic

    elastic.resume(snap, mesh)
    resumed = numerics.last_gauges("potrf")
    out["ckpt_resume"] = {"n": n, "every": NUM_CKPT_EVERY, "kill": NUM_CKPT_KILL,
                          "chain": chain, "resumed": resumed}
    check(snap is not None and snap.num_monitor and resumed == chain,
          f"num potrf_ckpt: resumed gauges {resumed} != the chain's {chain}")
    del w, d, snap
    secs["wilkinson_ckpt"] = time.perf_counter() - t0

    # 5. the health-routed f64 gesv_mesh at cond 1e8: routed to GMRES-IR
    # (num.routed_gmres 1, no IR solve), omega under the ladder's gate
    t0 = time.perf_counter()
    n = NUM_GESV_N
    rng = np.random.default_rng(NUMMEM_SEED + 7)
    q1 = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, n))).cuda())[0]
    q2 = torch.linalg.qr(torch.from_numpy(rng.standard_normal((n, n))).cuda())[0]
    a = (q1 * torch.logspace(0, -math.log10(NUM_GESV_COND), n, dtype=f64, device="cuda")) @ q2
    b = torch.from_numpy(rng.standard_normal((n, 1))).cuda()
    del q1, q2
    ir0, num0 = refine.ir_counter_values(), numerics.num_counter_values()
    t1 = time.perf_counter()
    # the ladder launches lu_rowsolve_tiles in f32 (its factor) and in f64
    # (the fallback): split by dtype at the call site
    from slate_tpu_torch.parallel import dist_lu

    with Capture(dist_lu, "lu_rowsolve_tiles", f32) as cap:
        x, info = counted("num_gesv", f64, lambda: mp.gesv_mesh(
            a, b, mesh, NB, opts={**on, Option.MaxIterations: NUM_GESV_RESTARTS}))
    secs["gesv_solve"] = time.perf_counter() - t1
    both = paths.pop("num_gesv")[1]
    split = {dt: {k: v for k, v in c.items() if v} for dt, c in (
        (f64, {**both, "lu_rowsolve_tiles": cap.calls.get("float64", 0)}),
        (f32, {"lu_rowsolve_tiles": cap.calls.get("float32", 0)}))}
    paths["num_gesv"], paths["num_gesv_factor"] = (f64, split[f64]), (f32, split[f32])
    check(sum(cap.calls.values()) == both.get("lu_rowsolve_tiles", 0),
          f"num gesv: lu_rowsolve_tiles calls {cap.calls}, launches {both}")
    ird = _ir_deltas(ir0, refine.ir_counter_values())
    routed = numerics.num_counter_values()["routed_gmres"] - num0["routed_gmres"]
    w_gate = GESV_LADDER_OMEGA * omega_gate(n, f64, torch)
    out["gesv"] = {"n": n, "cond": NUM_GESV_COND, "restarts": NUM_GESV_RESTARTS, "info": int(info),
                   "routed_gmres": routed,
                   "ir_deltas": ird, "condest": numerics.last_gauges("gesv").get("cond"),
                   "launches": paths["num_gesv"][1], "factor_launches": paths["num_gesv_factor"][1],
                   "omega": omega(a, x, b, torch), "omega_gate": w_gate}
    check(int(info) == 0 and routed == 1 and not ird.get("solves"),
          f"num gesv: routed {routed}, ir deltas {ird}")
    check(out["gesv"]["omega"] < w_gate, f"num gesv: omega {out['gesv']['omega']} >= {w_gate}")
    del a, b, x
    torch.cuda.empty_cache()
    secs["gesv_routed"] = time.perf_counter() - t0

    # 6. memwatch potrf on the card: the model within MODEL_TOL of the traced
    # temp, the traced bytes beside the allocator's peak, the tally the same
    # on the host and the card at n = 64, a memory-sampled flight Gantt
    t0 = time.perf_counter()
    n = MEM_POTRF_N
    rep = counted("mem_potrf", f32, lambda: memwatch.run_memwatch("potrf", n=n, nb=NB, depth=1,
                                                                 mesh=mesh))
    v = rep["values"]
    traced = v["mem.out_bytes"] + v["mem.temp_bytes"]
    alloc = v["mem.potrf_runtime_alloc_peak_bytes"]
    secs["memwatch_potrf"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    small = {dev: memwatch.run_memwatch("potrf", n=64, nb=8, depth=1, with_runtime=False,
                                        mesh=mp.make_mesh(P, Q, device=dev))["values"]
             for dev in ("cpu", "cuda")}
    tally_keys = ("mem.arg_bytes", "mem.out_bytes", "mem.temp_bytes", "mem.alias_bytes")
    secs["memwatch_small"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tr = memwatch.flight_memory_trace(mesh, n=MEM_FLIGHT_N, nb=NB, gen="torch", cols=OBS_COLS)
    secs["memwatch_flight"] = time.perf_counter() - t1
    terrs = perfetto.validate_chrome_trace(tr)
    mem_tracks = sorted({e["name"] for e in tr["traceEvents"]
                         if e.get("ph") == "C" and e["name"].startswith("mem.")})
    out["memwatch"] = {"n": n, **{k.split(".", 1)[1]: v[k] for k in v},
                       "traced_out_plus_temp": traced, "alloc_over_traced": alloc / traced,
                       "small_cpu": [small["cpu"][k] for k in tally_keys],
                       "small_cuda": [small["cuda"][k] for k in tally_keys],
                       "flight_mem_tracks": mem_tracks}
    check(v["mem.model_err_frac"] <= memwatch.MODEL_TOL,
          f"memwatch potrf: model off by {v['mem.model_err_frac']:.1%}")
    check(all(small["cpu"][k] == small["cuda"][k] for k in tally_keys),
          f"memwatch: the tally differs between the host and the card: {out['memwatch']}")
    check(not terrs and mem_tracks, f"memwatch flight trace: {terrs[:3]} tracks {mem_tracks}")

    # 7. the RunReport's mem and num sections, then one OOM: potrf_dist on a
    # stack of 0.6 of the card, whose copy the model puts past the card
    t0 = time.perf_counter()
    rep = report.make_report("slice10b", values={"x_seconds": 1.0})
    rerrs = report.validate_report(json.loads(json.dumps(rep)))
    out["report"] = {"mem": rep["mem"], "num": rep["num"], "problems": rerrs}
    check(not rerrs and rep["num"]["monitored"] > 0 and rep["mem"]["samples"] > 0,
          f"report sections: {out['report']}")
    total = torch.cuda.get_device_properties(0).total_memory
    step = NB * math.lcm(P, Q)
    n_oom = int(math.sqrt(0.6 * total / 4) // step) * step
    model = memmodel.MemoryModel("potrf", n_oom, NB, (P, Q))
    tiles = torch.empty((n_oom // NB, n_oom // NB, NB, NB), dtype=f32, device="cuda")
    d = mp.DistMatrix(tiles=tiles, m=n_oom, n=n_oom, nb=NB, mesh=mesh, diag_pad=True)
    n_reports = len(memory.OOM_REPORTS)
    raised = None
    try:
        mp.potrf_dist(d)
    except torch.cuda.OutOfMemoryError as e:
        raised = type(e).__name__
    reports = memory.OOM_REPORTS[n_reports:]
    del d, tiles
    torch.cuda.empty_cache()
    out["oom"] = {"n": n_oom, "model_virtual_peak_bytes": model.virtual_peak_bytes,
                  "card_bytes": total, "raised": raised, "reports": len(reports),
                  "report_head": reports[0].splitlines()[:3] if reports else []}
    check(model.virtual_peak_bytes > total, f"oom: the model's peak fits the card: {out['oom']}")
    check(raised == "OutOfMemoryError" and len(reports) == 1, f"oom: {out['oom']}")
    secs["report_oom"] = time.perf_counter() - t0
    obs.reset()

    emit(out)
    phase_total = time.perf_counter() - t_phase
    emit({"phase": "slice10b_seconds", **secs, "sum": phase_total, "budget": NUMMEM_BUDGET_S,
          "within_budget": phase_total <= NUMMEM_BUDGET_S, "card": smi_line})
    return [(k.replace("num_gesv_factor", "num_gesv"), dt, counts)
            for k, (dt, counts) in paths.items() if k.startswith(("num_", "mem_"))]


SERVE_BIG = 4096  # the largest serving bin: the f64 posv's left-looking route
SERVE_SMALL = 512
SERVE_BATCH = 8
SERVE_PACK = ((1024, 1000, 950, 900), 1024)  # k = 4 ragged problems, bin 1024 -> 4096
SERVE_STRADDLE = ((200, 190, 170), 200)  # bin 200: every tile straddles problems
SERVE_STREAM_BINS = (256, 512, 1024)
# the ragged sizes' range: posv up to bin 1024, gesv up to bin 512 (its
# condest probe's pivoted panel and the friendly tier's no-pivot leaves are
# host-bound eager loops: 5.2 s of an 11.2 s phase with gesv to 1024)
SERVE_STREAM_N = {"posv": (160, 1024), "gesv": (160, 512)}
SERVE_HOSTILE_N = 200
SERVE_RESIL_N = 2048
SERVE_CKPT_EVERY = 4
SERVE_KILL_STEP = 6
SERVE_GELS_MN = (4096, 2048)
SERVE_SEED = 400
SLICE11A_BUDGET_S = 10.0


def potrf_ll_leaves(n):
    """chol_diag_inv launches of one f64 potrf_array at n >= 4096 on the
    card, derived from its loop: potrf_left_looking_staged's panels, each
    one _potrf_and_inv whose recursion (blas3._split) ends in 256-wide
    leaves."""
    from slate_tpu_torch.blas3.blas3 import _NB, _split

    def leaves(k):
        if k <= _NB:
            return 1
        h = _split(k)
        return leaves(h) + leaves(k - h)

    nb = 4096 if n >= 16384 else 2048
    return -(-n // nb) * leaves(nb)


def serve_phase(kernels, mp, bucket_plan, smi_line, torch):
    """Slice 11a, the serving core, at the sizes it serves (bins 256-4096).
    Returns the launches of each path as [(serve_<path>, dtype, counts)]."""
    import numpy as np

    from slate_tpu_torch import obs
    from slate_tpu_torch.ft import inject
    from slate_tpu_torch.ft.checksum import threshold
    from slate_tpu_torch.ft.policy import FtPolicy
    from slate_tpu_torch.linalg.chol import posv_array
    from slate_tpu_torch.obs import perfetto
    from slate_tpu_torch.obs.metrics import serve_counts
    from slate_tpu_torch.serve import batch, smoke, trace, tune
    from slate_tpu_torch.serve.cache import ExecutableCache
    from slate_tpu_torch.serve.router import Router
    from slate_tpu_torch.types import Option, SlateError
    from slate_tpu_torch.utils import testing

    f32, f64 = torch.float32, torch.float64
    mesh = mp.make_mesh(P, Q, device="cuda")
    secs, paths, out = {}, {}, {"phase": "serve", "card": smi_line}
    obs.reset()
    t_phase = time.perf_counter()

    def counted(path, dtype, fn):
        reset_counts(kernels)
        res = fn()
        torch.cuda.synchronize()
        paths[path] = (dtype, {k: v for k, v in read_counts(kernels).items() if v})
        return res

    def deltas(before):
        after = serve_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def gate(n, dtype):
        return 100 * n * torch.finfo(dtype).eps

    # 1. the stacked batch driver: each row bitwise posv_array of its problem
    t0 = time.perf_counter()
    out["batched"] = {}
    for n, dtype in ((SERVE_BIG, f64), (SERVE_SMALL, f32), (SERVE_SMALL, f64)):
        a = torch.stack([dominant_spd(n, dtype, SERVE_SEED + i, torch)
                         for i in range(SERVE_BATCH)])
        b = randn((SERVE_BATCH, n, 1), dtype, SERVE_SEED + 50, torch)
        path = f"serve_posv_{n}" if n == SERVE_BIG else None
        t1 = time.perf_counter()
        xs, info = (counted(path, dtype, lambda: batch.posv_batched(a, b)) if path
                    else batch.posv_batched(a, b))
        torch.cuda.synchronize()
        s = time.perf_counter() - t1
        bitwise = all(torch.equal(xs[i], posv_array(a[i], b[i])[0]) for i in range(SERVE_BATCH))
        etas = [eta(a[i], xs[i], b[i], torch) for i in range(SERVE_BATCH)]
        key = f"{dname(dtype)}_{n}"
        out["batched"][key] = {"seconds": s, "solves_per_s": SERVE_BATCH / s, "bitwise": bitwise,
                               "info": info.tolist(), "eta_max": max(etas),
                               "eta_gate": gate(n, dtype)}
        check(bitwise and not any(info.tolist()) and max(etas) < gate(n, dtype),
              f"serve batched {key}: {out['batched'][key]}")
        del a, b, xs
    want = {"chol_diag_inv": SERVE_BATCH * potrf_ll_leaves(SERVE_BIG)}
    got = paths[f"serve_posv_{SERVE_BIG}"][1]
    out["batched"]["launches"], out["batched"]["expected_launches"] = got, want
    check(got == want, f"serve batched launches {got}, expected {want}")
    secs["batched"] = time.perf_counter() - t0

    # 2. the serving headline: stacked against the posv_mesh loop at 512
    t0 = time.perf_counter()
    thr = smoke.measure_throughput(mesh, n=SERVE_SMALL, batch=SERVE_BATCH)
    out["throughput"] = {k: v for k, v in thr.items() if k != "key"}
    check(thr["bitwise"] and thr["info_ok"], f"serve throughput: {out['throughput']}")
    check(thr["speedup"] >= 3.0, f"serve throughput: batched {thr['speedup']:.2f}x the loop, < 3x")
    secs["throughput"] = time.perf_counter() - t0

    # 3. the packed mesh posv: k ragged problems in one block-diagonal
    # operand, each solution bitwise the problem packed alone; then a bin
    # that is not a multiple of nb (tiles straddle two problems)
    t0 = time.perf_counter()
    direct = {Option.MixedPrecision: "off"}
    out["packed"] = {}
    for label, (sizes, m) in (("aligned", SERVE_PACK), ("straddle", SERVE_STRADDLE)):
        ops_ = [dominant_spd(n, f64, SERVE_SEED + 60 + i, torch) for i, n in enumerate(sizes)]
        rhs_ = [randn((n, 1), f64, SERVE_SEED + 70 + i, torch) for i, n in enumerate(sizes)]
        run = lambda: batch.posv_packed_mesh(ops_, rhs_, mesh, nb=NB, bins=(m,), opts=direct)
        xs, info = counted("serve_packed_posv", f64, run) if label == "aligned" else run()
        alone = []
        for i in range(len(sizes)):
            eye = torch.eye(m, dtype=f64, device="cuda")
            zero = torch.zeros((m, 1), dtype=f64, device="cuda")
            a1, b1 = batch.pack_block_diag([ops_[q] if q == i else eye for q in range(len(sizes))],
                                           m, [rhs_[q] if q == i else zero
                                               for q in range(len(sizes))])
            x1, _ = mp.posv_mesh(a1, b1, mesh, NB, direct)
            alone.append(torch.equal(xs[i], batch.unpack_block_diag(x1, sizes, m)[i]))
        etas = [eta(ops_[i], xs[i], rhs_[i], torch) for i in range(len(sizes))]
        out["packed"][label] = {"sizes": list(sizes), "bin": m, "info": int(info),
                                "bitwise_packed_alone": alone, "eta_max": max(etas)}
        check(int(info) == 0 and all(alone) and max(etas) < gate(m, f64),
              f"serve packed {label}: {out['packed'][label]}")
    nt = len(SERVE_PACK[0]) * SERVE_PACK[1] // NB
    want = expected_potrf_launches(nt, 1, bucket_plan)
    got = paths["serve_packed_posv"][1]
    out["packed"]["launches"], out["packed"]["expected_launches"] = got, want
    check(got == want, f"serve packed launches {got}, expected {want}")
    secs["packed"] = time.perf_counter() - t0

    # 4. a Router stream: 32 ragged f64 posv / gesv requests across bins
    # 256-1024 (friendly and hostile gesv: one operand at cond 1e9), obs on,
    # twice: one build per key, none in the second pass, one outcome each
    t0 = time.perf_counter()
    rng = np.random.default_rng(SERVE_SEED)
    router = Router(bins=SERVE_STREAM_BINS, cache=ExecutableCache())
    g = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 80)
    q1, _ = torch.linalg.qr(torch.randn((SERVE_HOSTILE_N,) * 2, generator=g, dtype=f64,
                                        device="cuda"))
    q2, _ = torch.linalg.qr(torch.randn((SERVE_HOSTILE_N,) * 2, generator=g, dtype=f64,
                                        device="cuda"))
    sing = torch.logspace(0, -9, SERVE_HOSTILE_N, dtype=f64, device="cuda")
    hostile = (q1 * sing) @ q2
    reqs = []
    for i in range(32):
        op = "gesv" if i % 2 else "posv"
        if i % 16 == 5:
            a = hostile
        else:
            lo, hi = SERVE_STREAM_N[op]
            n = int(rng.integers(lo, hi + 1))
            a = (dominant_spd(n, f64, SERVE_SEED + 100 + i, torch) if op == "posv"
                 else lu_matrix("nopiv", n, f64, SERVE_SEED + 100 + i, torch))
        reqs.append((op, a, randn((a.shape[0], 1), f64, SERVE_SEED + 140 + i, torch)))
    obs.enable()
    trace.reset()
    c0 = serve_counts()
    t1 = time.perf_counter()
    xs1 = router.solve_batch(reqs)
    torch.cuda.synchronize()
    pass1 = time.perf_counter() - t1
    snap = router.cache.snapshot_traces()
    t1 = time.perf_counter()
    xs2 = router.solve_batch(reqs)
    torch.cuda.synchronize()
    pass2 = time.perf_counter() - t1
    d = deltas(c0)
    steady = True
    try:
        router.cache.assert_steady(snap)
        router.cache.assert_steady()
    except AssertionError:
        steady = False
    traces = trace.finished_traces()
    sla = trace.sla_values()
    doc = perfetto.request_chrome_trace(traces)
    terrs = perfetto.validate_chrome_trace(json.loads(json.dumps(doc)))
    quant = {}
    for op, klass in (("posv", "friendly"), ("gesv", "friendly"), ("gesv", "hostile")):
        quant[f"{op}_{klass}"] = [sla.get(f"latency_{q}_{op}_{klass}_s") for q in
                                  ("p50", "p95", "p99")]
    eta_max, hostile_resid = 0.0, 0.0
    for (op, a, b), x in zip(reqs, xs1):
        if a is hostile:
            hostile_resid = max(hostile_resid, float((a @ x - b).abs().max()))
        else:
            eta_max = max(eta_max, eta(a, x, b, torch) / gate(a.shape[0], f64))
    same = all(torch.equal(x1, x2) for x1, x2 in zip(xs1, xs2))
    out["router"] = {"requests": len(reqs), "pass_seconds": [pass1, pass2],
                     "solves_per_s": [len(reqs) / pass1, len(reqs) / pass2],
                     "programs": len(router.cache), "counter_deltas": d,
                     "outcomes": sorted({t.outcome for t in traces}), "traces": len(traces),
                     "quantiles_s": quant, "timeline_problems": terrs[:3],
                     "eta_over_gate_max": eta_max, "hostile_max_abs_residual": hostile_resid,
                     "pass2_bitwise_pass1": same, "steady": steady}
    check(len(traces) == 2 * len(reqs) and all(t.outcome == "served" for t in traces),
          f"serve router: {len(traces)} traces, outcomes {out['router']['outcomes']}")
    check(steady and d.get("traces") == len(router.cache) and d.get("cache_misses") == d["traces"],
          f"serve router cache: {out['router']}")
    check(d.get("class_hostile") == 4 and d.get("requests") == 2 * len(reqs),
          f"serve router classes: {d}")
    check(not terrs and all(q[0] is not None and 0 <= q[0] <= q[1] <= q[2]
                            for q in quant.values()), f"serve router SLA: {out['router']}")
    check(eta_max < 1 and hostile_resid < 1e-4 and same, f"serve router answers: {out['router']}")
    obs.disable()
    del reqs, xs1, xs2, hostile
    secs["router"] = time.perf_counter() - t0

    # 5. the resilient mesh path at f64 n = 2048 (2 x 4, nb = 256): a
    # checkpointed posv killed at step 6 and resumed (bitwise the unbroken
    # chain), a gesv under FaultTolerance with one transient fault (one
    # retry), and a kill before the first snapshot (rejected)
    t0 = time.perf_counter()
    n = SERVE_RESIL_N
    nt = n // NB
    a = dominant_spd(n, f64, SERVE_SEED + 200, torch)
    b = randn((n, 1), f64, SERVE_SEED + 201, torch)
    ck = Router(mesh=mesh, nb=NB, bins=(n,), cache=ExecutableCache(),
                opts={Option.Checkpoint: SERVE_CKPT_EVERY, Option.NumMonitor: "off"})
    x_chain = ck.solve("posv", a, b)
    c0 = serve_counts()
    t1 = time.perf_counter()
    with inject.fault_scope(inject.FaultPlan([inject.KillFault("potrf", SERVE_KILL_STEP)])):
        x_res = counted("serve_resume_posv", f64, lambda: ck.solve("posv", a, b))
    resume_s = time.perf_counter() - t1
    d_res = deltas(c0)
    obs.enable()
    before = len(trace.finished_traces())
    c0 = serve_counts()
    rejected = None
    with inject.fault_scope(inject.FaultPlan([inject.KillFault("potrf", 1)])):
        try:
            ck.solve("posv", a, b)
        except SlateError as e:
            rejected = str(e)
    d_rej = deltas(c0)
    rej_out = [t.outcome for t in trace.finished_traces()[before:]]
    obs.disable()
    a_lu = lu_matrix("nopiv", n, f64, SERVE_SEED + 202, torch)
    ft = Router(mesh=mesh, nb=NB, bins=(n,), cache=ExecutableCache(),
                opts={Option.FaultTolerance: FtPolicy.Detect, Option.NumMonitor: "off"})
    k = nt - 3
    flip = inject.Fault("getrf_nopiv", k=k, phase="panel", ti=nt - 1, tj=k, r=(nt - 1) % P,
                        c=k % Q, mode=inject.MODE_FLIP,
                        value=10 * threshold(n, f64, nt * 2 * float(a_lu.abs().max())))
    c0 = serve_counts()
    t1 = time.perf_counter()
    with inject.fault_scope(inject.FaultPlan([flip])):
        x_ft = counted("serve_gesv_ft", f64, lambda: ft.solve("gesv", a_lu, b))
    retry_s = time.perf_counter() - t1
    d_ft = deltas(c0)
    out["resilient"] = {
        "n": n, "every": SERVE_CKPT_EVERY, "kill": SERVE_KILL_STEP, "resume_seconds": resume_s,
        "resume_deltas": d_res, "resume_bitwise_chain": bool(torch.equal(x_res, x_chain)),
        "resume_eta": eta(a, x_res, b, torch), "unresumable": rejected, "reject_deltas": d_rej,
        "reject_outcomes": rej_out, "retry_seconds": retry_s, "retry_deltas": d_ft,
        "retry_omega": omega(a_lu, x_ft, b, torch), "omega_gate": omega_gate(n, f64, torch),
        "launches": {p_: paths[p_][1] for p_ in ("serve_resume_posv", "serve_gesv_ft")}}
    check(d_res.get("resumes") == 1 and out["resilient"]["resume_bitwise_chain"]
          and out["resilient"]["resume_eta"] < gate(n, f64),
          f"serve resume: {out['resilient']}")
    check(rejected and "unresumable" in rejected and d_rej.get("admission_rejects") == 1
          and rej_out == ["reject_unresumable"], f"serve unresumable: {out['resilient']}")
    check(d_ft.get("retries") == 1 and out["resilient"]["retry_omega"] < omega_gate(n, f64, torch),
          f"serve ft retry: {out['resilient']}")
    want_res = expected_ckpt_launches("potrf", nt)
    want_ft = {k_: 2 * v for k_, v in expected_ft_launches("lu", nt, 1).items()}
    check(paths["serve_resume_posv"][1] == want_res,
          f"serve resume launches {paths['serve_resume_posv'][1]}, expected {want_res}")
    check(paths["serve_gesv_ft"][1] == want_ft,
          f"serve ft launches {paths['serve_gesv_ft'][1]}, expected {want_ft}")
    del a, b, a_lu, x_chain, x_res, x_ft
    secs["resilient"] = time.perf_counter() - t0

    # 6. the gels tier: CAQR at f64 4096 x 2048 with NumMonitor on, tester.py's
    # residual gate, no re-orthogonalization retry on a sound operand
    t0 = time.perf_counter()
    m, n = SERVE_GELS_MN
    a = randn((m, n), f64, SERVE_SEED + 300, torch)
    b = randn((m, NRHS), f64, SERVE_SEED + 301, torch)
    gr = Router(mesh=mesh, nb=NB, cache=ExecutableCache(), opts={Option.NumMonitor: "on"})
    c0 = serve_counts()
    x = counted("serve_gels", f64, lambda: gr.gels(a, b))
    d_g = deltas(c0)
    res, om = gels_residual(a, x, b), testing.gels_omega(a, x, b)
    nt = n // NB
    want = {"qr_panel_offset": nt, "qr_panel": nt * (P - 1)}
    out["gels"] = {"m": m, "n": n, "residual": res, "residual_gate": 100 * n * 2.0 ** -52,
                   "omega": om, "omega_gate": testing.gels_omega_gate(m, f64),
                   "deltas": d_g, "launches": paths["serve_gels"][1], "expected_launches": want}
    check(res < 100 * n * 2.0 ** -52 and om < testing.gels_omega_gate(m, f64)
          and "retries" not in d_g, f"serve gels: {out['gels']}")
    check(paths["serve_gels"][1] == want,
          f"serve gels launches {paths['serve_gels'][1]}, expected {want}")
    del a, b, x
    torch.cuda.empty_cache()
    secs["gels"] = time.perf_counter() - t0

    # 7. the tuner's stationary-variant timing (GemmA against GemmC at the
    # thin-output serving shape, f64 2048): GemmC's kt summa_update a run
    t0 = time.perf_counter()
    n, reps = SERVE_RESIL_N, 3
    times = counted("serve_tune_gemm", f64, lambda: tune.time_gemm_method(n, NB, mesh, reps))
    want = {"summa_update": (1 + reps) * (n // NB)}
    out["tune_gemm"] = {"n": n, "seconds": times, "launches": paths["serve_tune_gemm"][1],
                        "expected_launches": want}
    check(paths["serve_tune_gemm"][1] == want and all(v > 0 for v in times.values()),
          f"serve tune gemm: {out['tune_gemm']}")
    secs["tune_gemm"] = time.perf_counter() - t0
    obs.reset()

    emit(out)
    phase_total = time.perf_counter() - t_phase
    emit({"phase": "slice11a_seconds", **secs, "sum": phase_total, "budget": SLICE11A_BUDGET_S,
          "within_budget": phase_total <= SLICE11A_BUDGET_S, "card": smi_line})
    return [(k_, dt, counts) for k_, (dt, counts) in paths.items()]


SQ_BINS = (512, 4096)  # gesv at 512, posv at the largest serving bin
SQ_POSV = 64           # posv f64 requests, ragged in SQ_POSV_N: all at bin 4096
SQ_POSV_N = (3000, 4096)
SQ_GESV_AT = (10, 26, 42, 58)  # stream positions of the gesv f64 requests
SQ_GESV_N = (400, 512)
SQ_CLIENTS = 8
SQ_B, SQ_T = 8, 0.005
SQ_HTTP_N, SQ_HTTP_REQUESTS, SQ_HTTP_CLIENTS = 64, 16, 4
SQ_SEED = 500
SLICE11B_BUDGET_S = 10.0


def serve_queue_phase(kernels, mp, bucket_plan, smi_line, torch):
    """Slice 11b, the service layer, on the card: concurrent submitters into
    a Service at bin 4096 against the same requests one at a time, the
    packed dispatch through a mesh Router, the HTTP front door, then
    serve.queue_smoke and obs.live --ci.  Returns the launches of each path
    as [(serve_queue_<path>, dtype, counts)]."""
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from slate_tpu_torch import obs
    from slate_tpu_torch.obs import live
    from slate_tpu_torch.obs.metrics import serve_counts
    from slate_tpu_torch.serve import batch, queue_smoke, trace
    from slate_tpu_torch.serve.cache import ExecutableCache
    from slate_tpu_torch.serve.queue import BatchQueue, ManualClock, packed_mesh_body
    from slate_tpu_torch.serve.router import Router
    from slate_tpu_torch.serve.service import Service, start_http
    from slate_tpu_torch.types import Option

    f64 = torch.float64
    secs, paths, out = {}, {}, {"phase": "serve_queue", "card": smi_line}
    obs.reset()
    t_phase = time.perf_counter()

    def counted(path, dtype, fn):
        reset_counts(kernels)
        res = fn()
        torch.cuda.synchronize()
        paths[path] = (dtype, {k: v for k, v in read_counts(kernels).items() if v})
        return res

    def deltas(before):
        after = serve_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    # 1. concurrent submitters: SQ_CLIENTS threads call Service.solve (wall
    # clock, worker and controller) with 64 ragged posv f64 at bin 4096 and
    # a few gesv f64 at bin 512, two tenants weighted 2:1; then the same
    # requests one at a time through Router.solve on a fresh Router
    t0 = time.perf_counter()
    rng = np.random.default_rng(SQ_SEED)
    reqs, posv_at = [], []
    for i in range(SQ_POSV + len(SQ_GESV_AT)):
        if i in SQ_GESV_AT:
            n = int(rng.integers(SQ_GESV_N[0], SQ_GESV_N[1] + 1))
            a = lu_matrix("nopiv", n, f64, SQ_SEED + i, torch)
            op = "gesv"
        else:
            n = int(rng.integers(SQ_POSV_N[0], SQ_POSV_N[1] + 1))
            a = dominant_spd(n, f64, SQ_SEED + i, torch)
            op = "posv"
            posv_at.append(i)
        reqs.append((op, a, randn((n, 1), f64, SQ_SEED + 1000 + i, torch),
                     "zeta" if i % 3 == 2 else "acme"))
    torch.cuda.synchronize()
    secs["operands"] = time.perf_counter() - t0
    svc = Service(Router(bins=SQ_BINS, cache=ExecutableCache()), max_batch=SQ_B, window_s=SQ_T,
                  weights={"acme": 2.0, "zeta": 1.0}, name="chip_serve_queue",
                  request_timeout_s=120.0)
    got, lat, errors = {}, {}, []

    def client(k):
        for i in range(k, len(reqs), SQ_CLIENTS):
            op, a, b, tenant = reqs[i]
            t1 = time.perf_counter()
            try:
                got[i] = svc.solve(op, a, b, tenant=tenant)
            except Exception as e:  # every failure fails the phase below
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            lat[i] = time.perf_counter() - t1

    obs.enable()
    trace.reset()
    c0 = serve_counts()
    t0 = time.perf_counter()

    def run_clients():
        svc.start()
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(SQ_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        return [th for th in threads if th.is_alive()]

    try:
        hung = counted("serve_queue_concurrent", f64, run_clients)
    finally:
        svc.stop()
    wall = time.perf_counter() - t0
    d = deltas(c0)
    sla = trace.sla_values()
    traces = trace.finished_traces()
    actuations = [(a_["action"], a_["batch"], a_["window_s"]) for a_ in svc.controller.actuations]
    # the same requests one at a time (obs on as above: the same fences)
    ref = Router(bins=SQ_BINS, cache=ExecutableCache())
    t1 = time.perf_counter()
    xs_ref = {}
    for i, (op, a, b, tenant) in enumerate(reqs):
        xs_ref[i] = ref.solve(op, a, b, tenant=tenant)
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t1
    obs.disable()
    bitwise = [i for i in range(len(reqs)) if i in got and torch.equal(got[i], xs_ref[i])]
    etas = [eta(reqs[i][1], got[i], reqs[i][2], torch) / (100 * reqs[i][1].shape[0] * 2.0 ** -52)
            for i in posv_at if i in got]
    quant = {f"{op}_friendly": [sla.get(f"latency_{q}_{op}_friendly_s") for q in
                                ("p50", "p95", "p99")] for op in ("posv", "gesv")}
    want = {"chol_diag_inv": SQ_POSV * potrf_ll_leaves(SQ_POSV_N[1])}
    got_l = paths["serve_queue_concurrent"][1]
    out["concurrent"] = {
        "requests": len(reqs), "posv": SQ_POSV, "gesv": len(SQ_GESV_AT), "clients": SQ_CLIENTS,
        "B": SQ_B, "T_s": SQ_T, "seconds": wall, "requests_per_s": len(reqs) / wall,
        "windows": d.get("queue_windows", 0), "windows_full": d.get("queue_window_full", 0),
        "windows_expired": d.get("queue_window_expired", 0),
        "pump_errors": d.get("queue_pump_errors", 0), "errors": errors[:3], "hung": len(hung),
        "quantiles_s": quant, "client_latency_s": {
            "p50": float(np.percentile(list(lat.values()), 50)),
            "max": max(lat.values())},
        "outcomes": sorted({t_.outcome for t_ in traces}), "traces": len(traces),
        "controller_actuations": actuations,
        "sync_seconds": sync_wall, "sync_requests_per_s": len(reqs) / sync_wall,
        "ratio_concurrent_over_sync": (len(reqs) / wall) / (len(reqs) / sync_wall),
        "bitwise_router_solve": len(bitwise), "eta_over_gate_max": max(etas),
        "launches": got_l, "expected_launches": want, "operand_seconds": secs["operands"]}
    check(not errors and not hung and len(got) == len(reqs),
          f"serve_queue concurrent: {out['concurrent']}")
    check(len(bitwise) == len(reqs), f"serve_queue bitwise: {out['concurrent']}")
    check(len(traces) == len(reqs) and all(t_.outcome == "served" for t_ in traces),
          f"serve_queue traces: {out['concurrent']}")
    check(d.get("queue_pump_errors", 0) == 0 and d.get("queue_dispatched") == len(reqs)
          and max(etas) < 1, f"serve_queue counters: {d}")
    check(all(q_[0] is not None and 0 <= q_[0] <= q_[1] <= q_[2] for q_ in quant.values()),
          f"serve_queue SLA: {quant}")
    check(got_l == want, f"serve_queue launches {got_l}, expected {want}")
    del reqs, got, xs_ref
    torch.cuda.empty_cache()
    secs["concurrent"] = time.perf_counter() - t0

    # 2. packed dispatch through a mesh Router: a ragged posv window of four
    # at bin 1024 runs as one block-diagonal program on 2 x 4, nb = 256, each
    # solution bitwise the problem packed alone
    t0 = time.perf_counter()
    mesh = mp.make_mesh(P, Q, device="cuda")
    sizes, m = SERVE_PACK
    opts = {Option.MixedPrecision: "off", Option.AutoTune: "off", Option.BlockSize: NB}
    mr = Router(mesh=mesh, nb=NB, bins=(m,), cache=ExecutableCache(), opts=opts)
    q = BatchQueue(mr, max_batch=len(sizes), window_s=SQ_T, clock=ManualClock(),
                   dispatch="packed", name="chip_serve_packed")
    ops_ = [dominant_spd(n, f64, SQ_SEED + 2000 + i, torch) for i, n in enumerate(sizes)]
    rhs_ = [randn((n, 1), f64, SQ_SEED + 2100 + i, torch) for i, n in enumerate(sizes)]
    c0 = serve_counts()
    try:
        tks = counted("serve_queue_packed", f64,
                      lambda: [q.submit("posv", a, b) for a, b in zip(ops_, rhs_)])
    finally:
        q.close()
    dp = deltas(c0)
    body, _merged = packed_mesh_body(mesh, len(sizes) * m, "float64", opts)
    alone = []
    for i in range(len(sizes)):
        eye = torch.eye(m, dtype=f64, device="cuda")
        zero = torch.zeros((m, 1), dtype=f64, device="cuda")
        a1, b1 = batch.pack_block_diag([ops_[k] if k == i else eye for k in range(len(sizes))], m,
                                       [rhs_[k] if k == i else zero for k in range(len(sizes))])
        x1, _ = body(a1, b1)
        alone.append(bool(torch.equal(tks[i].result(), batch.unpack_block_diag(x1, sizes, m)[i])))
    want = expected_potrf_launches(len(sizes) * m // NB, 1, bucket_plan)
    out["packed"] = {"sizes": list(sizes), "bin": m, "deltas": dp, "bitwise_packed_alone": alone,
                     "eta_max": max(eta(ops_[i], tks[i].result(), rhs_[i], torch)
                                    for i in range(len(sizes))),
                     "launches": paths["serve_queue_packed"][1], "expected_launches": want}
    check(dp.get("queue_packed_dispatches") == 1 and dp.get("queue_windows") == 1
          and all(alone) and all(t_.done() for t_ in tks), f"serve_queue packed: {out['packed']}")
    check(paths["serve_queue_packed"][1] == want,
          f"serve_queue packed launches {paths['serve_queue_packed'][1]}, expected {want}")
    del ops_, rhs_, tks
    secs["packed"] = time.perf_counter() - t0

    # 3. the HTTP front door: SQ_HTTP_CLIENTS threads POST /solve at n = 64,
    # one malformed body (400), one budget refusal (429), the scrapes
    t0 = time.perf_counter()
    hs = Service(Router(bins=(SQ_HTTP_N,), cache=ExecutableCache()), max_batch=4,
                 window_s=SQ_T, budgets={"tiny": 1000}, name="chip_serve_http",
                 request_timeout_s=60.0)
    g = np.random.default_rng(SQ_SEED + 3000)
    bodies = []
    for i in range(SQ_HTTP_REQUESTS):
        u = g.standard_normal((SQ_HTTP_N, SQ_HTTP_N))
        bodies.append({"op": "posv", "a": (u @ u.T / SQ_HTTP_N + 2 * np.eye(SQ_HTTP_N)).tolist(),
                       "b": g.standard_normal(SQ_HTTP_N).tolist(),
                       "tenant": "acme" if i % 2 else "zeta"})
    codes, answers = {}, {}

    def post(port, body):
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/solve", data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, None

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.read().decode()

    srv = None
    obs.enable()
    try:
        hs.start()
        srv, _th, port = start_http(hs, 0)

        def http_client(k):
            for i in range(k, SQ_HTTP_REQUESTS, SQ_HTTP_CLIENTS):
                codes[i], answers[i] = post(port, bodies[i])

        threads = [threading.Thread(target=http_client, args=(k,), daemon=True)
                   for k in range(SQ_HTTP_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        malformed = post(port, b'{"op": "posv", "a": [[1.0, 2.0], [3.0]]')[0]
        refused = post(port, dict(bodies[0], tenant="tiny"))[0]
        qdoc = json.loads(get(port, "/queue.json"))
        health = get(port, "/healthz").splitlines()
        text = get(port, "/metrics")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        hs.stop()
        obs.disable()
    href = Router(bins=(SQ_HTTP_N,), cache=ExecutableCache())
    http_bitwise = sum(
        1 for i, ans in answers.items() if ans is not None and torch.equal(
            torch.tensor(ans["x"], dtype=f64),
            href.solve("posv", torch.tensor(bodies[i]["a"], dtype=f64, device="cuda"),
                       torch.tensor(bodies[i]["b"], dtype=f64, device="cuda")).cpu()))
    prom_errs = live.validate_prometheus_text(text)
    all_codes = list(codes.values()) + [malformed, refused]
    out["http"] = {"requests": SQ_HTTP_REQUESTS, "clients": SQ_HTTP_CLIENTS, "n": SQ_HTTP_N,
                   "codes": sorted(set(codes.values())), "malformed": malformed,
                   "budget_refusal": refused, "bitwise_router_solve": http_bitwise,
                   "queue_json_depth": qdoc["queues"]["chip_serve_http"]["depth"],
                   "healthz": health, "prometheus_problems": prom_errs[:3],
                   "seconds": time.perf_counter() - t0}
    check(len(codes) == SQ_HTTP_REQUESTS and set(codes.values()) == {200}
          and http_bitwise == SQ_HTTP_REQUESTS and malformed == 400 and refused == 429
          and not any(c >= 500 for c in all_codes), f"serve_queue http: {out['http']}")
    check(health[0] == "ok" and not prom_errs and "slate_tpu_serve_queue_submitted" in text,
          f"serve_queue scrape: {out['http']}")
    secs["http"] = time.perf_counter() - t0

    # 4. the acceptance runs on the card, into the git-ignored chiprun_out/
    t0 = time.perf_counter()
    rc_q = counted("serve_queue_smoke", f64,
                   lambda: queue_smoke.run_smoke(os.path.join("chiprun_out", "serve_queue"),
                                                 device="cuda"))
    secs["queue_smoke"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        rc_l = counted("serve_queue_live_ci", f64,
                       lambda: live.run_ci(os.path.join("chiprun_out", "obs_live"), device="cuda"))
    finally:
        obs.disable()
        obs.reset()
    secs["live_ci"] = time.perf_counter() - t0
    out["acceptance"] = {"queue_smoke_rc": rc_q, "live_ci_rc": rc_l,
                         "launches": {p_: paths[p_][1] for p_ in ("serve_queue_smoke",
                                                                  "serve_queue_live_ci")}}
    check(rc_q == 0 and rc_l == 0, f"serve_queue acceptance: {out['acceptance']}")

    emit(out)
    phase_total = time.perf_counter() - t_phase
    emit({"phase": "slice11b_seconds", **secs, "sum": phase_total, "budget": SLICE11B_BUDGET_S,
          "within_budget": phase_total <= SLICE11B_BUDGET_S, "card": smi_line})
    return [(k_, dt, counts) for k_, (dt, counts) in paths.items() if counts]


def dryrun_phase():
    from slate_tpu_torch.parallel import dryrun

    res = dryrun.dryrun("cuda")
    emit({"phase": "dryrun", **res})
    check(res["ok"] and list(res["phases"]) == ["posv_chain", "gesv_pp", "hemm_summa", "stedc_dist",
                                                "heev_chain", "panel_pallas", "flight_timeline",
                                                "mem"],
          f"dryrun failed: {res['phases']}")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "slate_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (slate_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from slate_tpu_torch.linalg.chol import posv_array, potrf_array
    from slate_tpu_torch.ops import _build, kernels
    from slate_tpu_torch import parallel as mp
    from slate_tpu_torch.parallel.comm import bucket_plan, local_indices
    from slate_tpu_torch.parallel.dryrun import posv_chain
    from slate_tpu_torch.utils import testing

    # 1. card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    check(smi_line, f"nvidia-smi failed: {smi.stderr.strip()}")
    emit({"phase": "card", "device": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line, "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 residual products (the default)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names) + 1) as pool:
        prof_start = pool.submit(profiler_start, torch)
        list(pool.map(_build.load, names))
        prof_seconds = prof_start.result()
    emit({"phase": "build", "sources": names, "seconds": time.perf_counter() - t0,
          "profiler_start_seconds": prof_seconds})
    ptxas = {name: ptxas_report(_build.log_path(name)) for name in names}
    # the QR panel's dynamic shared memory at its path shapes (bytes)
    m_leaf = {dname(dt): GELS_MN[dname(dt)][0] for dt in (torch.float32, torch.float64)}
    qr_smem = {f"{dn}": {"leaf": kernels.qr_panel_smem_bytes(dt, 1, m_leaf[dn], QR_LEAF_W),
                         "merge": kernels.qr_panel_smem_bytes(dt, 1, 2 * NB, NB),
                         "offset": kernels.qr_panel_smem_bytes(dt, P, m_leaf[dn] // NB // P * NB, NB)}
               for dt, dn in ((torch.float32, "float32"), (torch.float64, "float64"))}
    mm_smem = {f"{name}_k{k}": kernels.matmul_core_smem_bytes(getattr(torch, name), k)
               for _, _, k, _, name in MATMUL_CASES}
    emit({"phase": "ptxas", "kernels": ptxas, "qr_panel_dynamic_smem_bytes": qr_smem,
          "matmul_core_dynamic_smem_bytes": mm_smem})
    for name in ("tile_gemm", "ft_summa_update", "matmul", "tile_ops"):
        spills = {k: v["spill_bytes"] for k, v in ptxas[name].items() if v["spill_bytes"]}
        check(ptxas[name] and not spills, f"ptxas: {name} spills {spills}")

    # 3. kernel vs twin
    rows = [kernel_phase(dt, kernels, torch) for dt in (torch.float32, torch.float64)]
    # 4-5. the single-chip path
    posv_seconds = {}
    for row, dt in zip(rows, (torch.float32, torch.float64)):
        row["launches"], posv_seconds[dt] = posv_phase(dt, kernels, posv_array, torch)
    # 6-7. small reference solve, non-SPD info codes
    small_phase(torch)
    non_spd_phase(kernels, potrf_array, torch)

    # 8. the mesh kernels vs their twins
    mesh_rows = {}
    for dt in (torch.float32, torch.float64):
        mesh_rows[("chol_panel_tiles", dt)] = kernel_panel_phase(dt, kernels, mp.local_view, torch)
        mesh_rows[("chol_trailing_update", dt)] = kernel_update_phase(
            "chol_trailing_update", dt, kernels, mp.local_view, local_indices, torch)
    mesh_rows[("summa_update", torch.float32)] = kernel_update_phase(
        "summa_update", torch.float32, kernels, mp.local_view, local_indices, torch)
    tile_mma_edges_phase(kernels, testing, torch)

    # 9-11. the mesh paths; every count is read right after its path
    counts = {dt: mesh_posv_phase(dt, kernels, mp, bucket_plan, torch)
              for dt in (torch.float32, torch.float64)}
    counts[torch.float32]["summa_update"] = mesh_gemm_phase(kernels, mp, torch)["summa_update"]
    for (name, dt), row in mesh_rows.items():
        row["launches"] = counts[dt][name]
        check(row["launches"], f"{row['name']}: no launch on its path")
    rows += list(mesh_rows.values())

    # 12. the LU kernels vs their twins
    lu_rows = {}
    for dt in (torch.float32, torch.float64):
        for row in kernel_lu_panel_phase(dt, kernels, mp.local_view, torch):
            lu_rows[(row["name"].split("[")[0], dt)] = row
        lu_rows[("lu_trailing_update", dt)] = kernel_update_phase(
            "lu_trailing_update", dt, kernels, mp.local_view, local_indices, torch)

    # 13-15. the mesh LU solves; every count is read right after its path.
    # The no-pivot solve reaches all three kernels; its counts go in the
    # kernels line
    lu_counts = {dt: mesh_lu_phase("nopiv", dt, kernels, mp, bucket_plan, torch)
                 for dt in (torch.float32, torch.float64)}
    for dt in (torch.float32, torch.float64):
        mesh_lu_phase("pp", dt, kernels, mp, bucket_plan, torch)
    mesh_lu_phase("tntpiv", torch.float32, kernels, mp, bucket_plan, torch)
    for (name, dt), row in lu_rows.items():
        row["launches"] = lu_counts[dt][name]
        check(row["launches"], f"{row['name']}: no launch on its path")
    rows += list(lu_rows.values())

    # 16-18. the QR kernels vs their twins, gels on one card and on the mesh;
    # every count is read right after its path: qr_panel's row takes the
    # single-chip gels (its leaves), qr_panel_offset's the mesh gels
    qr_rows = {}
    for dt in (torch.float32, torch.float64):
        for row in kernel_qr_phase(dt, kernels, torch):
            qr_rows[(row["name"].split("[")[0], dt)] = row
    kernel_qr_edges_phase(kernels, testing, torch)
    for dt in (torch.float32, torch.float64):
        gcounts, x_single = gels_phase(dt, kernels, torch)
        mcounts = mesh_gels_phase(dt, kernels, mp, x_single, torch)
        del x_single
        qr_rows[("qr_panel", dt)]["launches"] = gcounts["qr_panel"]
        qr_rows[("qr_panel_offset", dt)]["launches"] = mcounts["qr_panel_offset"]
    for row in qr_rows.values():
        check(row["launches"], f"{row['name']}: no launch on its path")
    rows += list(qr_rows.values())

    # 19-23. the FT kernel vs its twin, then the ABFT mesh paths; every count
    # is read right after its path: ft_summa_update's rows take the clean
    # gemm_ft runs
    ft_rows = {dt: kernel_ft_summa_phase(dt, kernels, testing, local_indices, torch)
               for dt in (torch.float32, torch.float64)}
    for dt, row in ft_rows.items():
        row["launches"] = mesh_gemm_ft_phase(dt, kernels, mp, torch)["ft_summa_update"]
        check(row["launches"], f"{row['name']}: no launch on its path")
    rows += list(ft_rows.values())
    for form in ("potrf", "lu"):
        for dt in (torch.float32, torch.float64):
            mesh_factor_ft_phase(form, dt, kernels, mp, torch)
    ft_drivers_phase(mp, torch)
    ft_smoke_phase()

    # 24-25. invariants
    mesh_invariants_phase(mp, posv_chain, torch)
    lu_invariants_phase(mp, torch)

    # 26-31. the tile kernels vs their twins, then ops.transpose (the
    # transpose rows take its one launch per stack), the single-chip LU
    # solves and the mixed-precision solves
    tile_rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for row in kernel_tile_phase(dt, kernels, testing, torch):
            tile_rows[(row["name"].split("[")[0], dt)] = row
        tile_edges_phase(dt, kernels, testing, torch)
        tile_max_split_phase(dt, kernels, testing, torch)
    for dt in (torch.float32, torch.bfloat16):
        tile_rows[("transpose_tiles", dt)]["launches"] = tile_transpose_phase(dt, kernels, torch)
    for row in tile_rows.values():
        check(row["launches"], f"{row['name']}: no launch")
    rows += list(tile_rows.values())
    full_f64_seconds = gesv_phase(torch)
    gesv_methods_phase(torch)
    mixed_phase(full_f64_seconds, torch)
    lu_misc_phase(torch)

    # 32-35. the blocked GEMM vs its twin (its rows take the public entry's
    # launches), the Ozaki scheme, the f64 mesh ladder and its smoke
    rows += kernel_matmul_phase(kernels, testing, torch)
    ozaki_phase(mp, torch)
    rows.append(mixed_mesh_phase(kernels, mp, torch))
    mixed_smoke_phase()

    # 36-38. slice 4c: the mesh BLAS-3, the mesh inverses and estimators
    # (their launches of rows 6, 8 and 12 join those rows), the ABFT her2k
    for dt in (torch.float32, torch.float64):
        mesh_blas3_phase(dt, mp, torch)
    for dt in (torch.float32, torch.float64):
        inv = mesh_inverse_phase(dt, kernels, mp, bucket_plan, torch)
        for name, path in (("chol_panel_tiles", "potri"), ("chol_trailing_update", "potri"),
                           ("lu_rowsolve_tiles", "getri")):
            row = (mesh_rows if name.startswith("chol") else lu_rows)[(name, dt)]
            row["launches_by_path"] = {"mesh_posv" if path == "potri" else "mesh_gesv_nopiv":
                                       row["launches"], f"{path}_mesh": inv[path][name]}
            check(inv[path][name], f"{row['name']}: no launch on {path}_mesh")
    ft_her2k_phase(mp, torch)

    # 39-42. slice 6: eig and SVD.  heev_mesh / svd_mesh on the mesh and
    # heev_array / svd_array on one card; each count is read right after its
    # path, and qr_panel_offset's rows gain these paths' launches beside the
    # mesh gels', and the kernel held at the he2hb panel the path gave it
    eig_paths = {}
    for dt in (torch.float32, torch.float64):
        launches, first, last, _ = eig_mesh_phase(dt, kernels, mp, torch)
        eig_paths[dt] = {"heev_mesh": launches}
        taps = {"first": first, "last": last}
        eig_paths[dt]["svd_mesh"] = svd_mesh_phase(dt, kernels, mp, torch)[0]
        qr_rows[("qr_panel_offset", dt)]["at_he2hb_panel"] = kernel_qr_he2hb_phase(
            dt, taps, kernels, testing, torch)
        del taps, first, last
    eig_paths[torch.float32].update(eig_single_phase(kernels, torch))
    for dt, paths in eig_paths.items():
        row = qr_rows[("qr_panel_offset", dt)]
        row["launches_by_path"] = {"mesh_gels": row["launches"], **paths}
        for path, got in paths.items():
            check(got, f"{row['name']}: no launch on {path}")

    # 43-45. slice 7a: the band solvers.  The narrow and mesh band paths
    # launch no hand kernel; the wide route's chol_diag_inv launches join
    # row 5's f32 row
    band_single_phase(kernels, posv_seconds[torch.float32], torch)
    wide = band_wide_phase(kernels, torch)
    rows[0]["launches_by_path"] = {"posv": rows[0]["launches"], "pbsv_wide": wide}
    rows[0]["launches"] += wide
    band_mesh_phase(kernels, mp, torch)

    # 46-48. slice 7b: hesv, gesv_rbt, redistribute and the non-uniform
    # tiling.  Row 10 gains hesv_array's launches, rows 6, 11 and 12 (f32)
    # those of the non-uniform gemm_summa and posv; the three phases' own
    # seconds are summed against SLICE7B_BUDGET_S
    t7 = {}
    t0 = time.perf_counter()
    hesv = hesv_single_phase(kernels, testing, torch)
    t7["hesv_single"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gesv_rbt_phase(kernels, torch)
    t7["gesv_rbt"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nonuni = redistribute_mesh_phase(kernels, mp, bucket_plan, torch)
    t7["redistribute_mesh"] = time.perf_counter() - t0
    emit({"phase": "slice7b_seconds", **t7, "sum": sum(t7.values()), "budget": SLICE7B_BUDGET_S})
    for dt, got in hesv.items():
        qr_rows[("qr_panel_offset", dt)]["launches_by_path"]["hesv_array"] = got
    for name, path in (("chol_panel_tiles", "nonuniform_posv"),
                       ("chol_trailing_update", "nonuniform_posv"),
                       ("summa_update", "nonuniform_gemm")):
        row = mesh_rows[(name, torch.float32)]
        row.setdefault("launches_by_path", {"mesh_gemm" if name == "summa_update" else "mesh_posv":
                                            row["launches"]})[path] = nonuni[name]

    # 49. slice 9b: checkpoint and restart.  The chains' launches join the
    # f32 rows of the kernels they reach (rows 6-10, 12, 13)
    ckpt_launches = ckpt_mesh_phase(kernels, mp, smi_line, torch)
    main_path = {"chol_panel_tiles": "mesh_posv", "chol_trailing_update": "mesh_posv",
                 "lu_panel_tiles": "mesh_gesv_nopiv", "lu_rowsolve_tiles": "mesh_gesv_nopiv",
                 "lu_trailing_update": "mesh_gesv_nopiv", "qr_panel": "gels",
                 "qr_panel_offset": "mesh_gels"}
    by_name = {**mesh_rows, **lu_rows, **qr_rows}
    for op, counts in ckpt_launches.items():
        for name, got in counts.items():
            row = by_name[(name, torch.float32)]
            row.setdefault("launches_by_path", {main_path[name]: row["launches"]})[f"{op}_ckpt"] = got
            check(got, f"{row['name']}: no launch on {op}_ckpt")

    # 50. slice 10a: the observability core.  The flights' launches join the
    # f32 rows of the kernels they reach under flight_<op>, the
    # instrumented posv's under obs_posv
    flight_launches, obs_posv = obs_phase(kernels, mp, bucket_plan, smi_line, torch)
    main_path["summa_update"] = "mesh_gemm"
    for path, counts in [(f"flight_{op}", c) for op, c in flight_launches.items()] + \
            [("obs_posv", obs_posv)]:
        for name, got in counts.items():
            row = by_name[(name, torch.float32)]
            row.setdefault("launches_by_path", {main_path[name]: row["launches"]})[path] = got
            check(got, f"{row['name']}: no launch on {path}")

    # 51. slice 10b: numerics and memory observability.  Each monitored or
    # traced path's launches join the rows of the kernels it reaches (by
    # dtype) under num_<op> / mem_<op>
    by_label = {r["name"]: r for r in rows}
    main_path["summa_update[float64]"] = "mixed_posv"
    for path, dt, counts in obs_num_mem_phase(kernels, mp, smi_line, torch):
        for name, got in counts.items():
            row = by_label.get(f"{name}[{dname(dt)}]")
            if row is None:  # no row of this kernel at this dtype
                continue
            first = main_path.get(row["name"], main_path.get(name))
            row.setdefault("launches_by_path", {first: row["launches"]})[path] = got
            check(got, f"{row['name']}: no launch on {path}")

    # 52. slice 11a: the serving core.  Each path's launches join the rows of
    # the kernels it reaches (by dtype) under serve_<path>
    main_path["chol_diag_inv"] = "posv"
    for path, dt, counts in serve_phase(kernels, mp, bucket_plan, smi_line, torch):
        for name, got in counts.items():
            row = by_label[f"{name}[{dname(dt)}]"]
            first = main_path.get(row["name"], main_path.get(name))
            row.setdefault("launches_by_path", {first: row["launches"]})[path] = got
            check(got, f"{row['name']}: no launch on {path}")

    # 53. slice 11b: the service layer.  Each path's launches join the rows
    # of the kernels it reaches (by dtype) under serve_queue_<path>
    for path, dt, counts in serve_queue_phase(kernels, mp, bucket_plan, smi_line, torch):
        for name, got in counts.items():
            row = by_label.get(f"{name}[{dname(dt)}]")
            if row is None:  # no row of this kernel at this dtype
                continue
            first = main_path.get(row["name"], main_path.get(name))
            row.setdefault("launches_by_path", {first: row["launches"]})[path] = got
            check(got, f"{row['name']}: no launch on {path}")

    # 54. the dryrun
    dryrun_phase()

    # 55. the script's seconds, kernels line, card line, result
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
