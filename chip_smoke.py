"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

A full run is two processes on the card: this one runs the timed work
(the kernels' timings, the fleets, the MPC solves, phases 11, 14 and 21),
and a second one it starts after phase 12 (``--checks``) runs the untimed
fp64 checks beside it (the kernels against their plain versions in phases
3-4, 8 and 9, phases 7, 10 and 16, and the fp64 parts of phases 6, 13, 15
and 17-28: kernels against plain versions, inverse_tests, transition_ad
against transition_fd).  Phases 5, 6, 9, 11 and 12 run alone.  The second
process's lines are printed as they come, after ``checks |``; a failure in
either process fails the script.  Phase 6's loop is timed alone before the
second process starts, twice while it runs and once more after it ends,
and the four rates are printed.  A ``[time]`` line follows each phase in
both.

Phases, each printing one line; any failure raises and the script exits
non-zero:

1. env     -- versions, the card's name and power limit; TF32 off.
2. build   -- nvcc builds the Cholesky kernels from csrc/ for sm_90a.
3. kernel: chol_factor -- CUDA kernel against its plain torch version over
   n x B x dtype, plus the asymmetric-input, non-SPD and non-contiguous
   cases; every case must be bit-equal.
4. kernel: chol_solve  -- the same grid, one and three right-hand sides.
5. timing  -- each kernel against its plain version and against the one
   PyTorch call that computes the same function (torch.linalg.cholesky_ex,
   torch.cholesky_solve; the port never calls them) at the slice's shape,
   beside the least time the card could take (bound_ms).
6. slice: fleet step   -- 100 steps of 4096 humanoids (fp32) through the
   kernels; launch counts, finiteness, steps/s; device time by kernel over
   3 more steps (torch.profiler); then 5 steps of 64 lanes in fp64 with
   the kernels against 5 steps with the plain versions.
7. slice: inverse dynamics -- forward then compare_fwd_inv on 64 lanes
   (fp64, Newton with 100 iterations); solver_fwdinv <= 1e-6 on every lane.
8. kernel: chol_factor_jvp / chol_solve_jvp -- the forward-mode kernels,
   many tangents a lane, against their plain versions over n of the grid
   of phases 3-4 and (B, T) = every B of it with one tangent, and 1 and
   127 lanes with 3 and 75: tangent-major and lane-major operands,
   operands the same for all tangents (stride 0), absent dL and db,
   single-tangent calls; plus clamped pivots, asymmetric tangents,
   transposed inputs and the bench chunk (1024 lanes, 75 tangents);
   bit-equal.
9. kernel: main-path shapes, and timing: JVP kernels -- all four kernels
   against their plain versions, bit-equal, at every shape at which
   phases 6-28 launch them, the solve at its columns (n = 27 for the
   humanoid, the JVP kernels at
   (lanes, tangents) (8, 75) and (1, 75) fp64, (320, 75), (400, 75),
   (1024, 75) and the folded (76,800, 1), in both layouts; n = 1-6 for phase 18's and
   phase 19's models, each dof block and nv, the JVPs at (8, 7) fp64 and,
   on the tendon arm (n = 2), at 16 tangents a lane: (8) fp64 and the
   reach iLQR's linearization, (6,400) fp32 and (200) fp64; n = 6, 30
   and 36 for phase 20's models, the JVPs at (8, 72) fp64; phase 22's
   elliptic_pairs (n = 19 and its dof blocks) and sphere_budget (n = 120
   and its 6-dof blocks); phase 23's quadrupeds (n = 22, 28); phase 24's
   models (n = 1, 2, 13, 17 and 27, 36, 19 with their blocks), the dual
   solvers' M⁻¹ Jᵀ at nefc columns: 324 on the humanoid, 164 on box_stack's
   6-dof blocks, 44 on elliptic_pairs'; phase 25's flex scenes (n = 30,
   42, 69, 75, 87 and their 3- and 6-dof blocks), the JVPs at (8, 84) and
   (8, 138) fp64; phase 26's quadruped with its rangefinders (n = 22, the
   JVPs at (8, 68) fp64) and its transmission and sensor-tail scenes (n =
   1-6); phase 28's humanoid, the JVPs at (1024, 21) and (80, 75) fp32 and
   (8, 21) fp64); then at the
   bench's chunk (1024 lanes, 75 tangents) the JVP kernels timed against
   the plain versions, their bounds (L read once a lane) and
   torch.func.vmap over torch.func.jvp of torch.linalg.cholesky /
   torch.cholesky_solve (one call each, never called by the port).
10. slice: transition -- transition_ad on 8 lanes (fp64) of the Newton-100
   humanoid and of humanoid_mjx, with the kernels against the plain
   versions (<= 1e-9) and against transition_fd (centered, eps 1e-6;
   within 1e-4 of max|A|); JVP kernel launches > 0, at 75 tangents a lane.
11. slice: linearization chunk -- the dual step of the bench's chunk, 1024
   humanoid_mjx lanes x 75 tangents (fp32), by the folded route (76,800
   lane copies, one tangent each) and by transition_ad's vmap over jvp
   (one primal a lane), in one call: seconds, peak memory, launches,
   device time and launches and each kernel's µs a launch
   (torch.profiler); the folded copies must agree to the bit, and the
   vmap route's primal next state must equal step's to the bit.
12. slice: MPC fleet -- northstar.measure_solves_per_sec on humanoid_mjx,
   fp32, H = 100, 2 iLQR iterations, 8 alphas, F = 16, lin_batch = 20
   (a linearization chunk of 320 lanes x 75 tangents), n_apply = 100
   (the whole plan is executed), one timed run (its cold run, as long in
   PyTorch, cut for time); solves/s, finite
   lanes (>= 0.9), mean iterations, the plan cost's mean and median, peak
   memory, launches of all four kernels.  humanoid_mjx diverges from
   these states in C too (tests/test_torch_opt.py), so its plan costs
   measure the divergence.
13. slice: MPC on the Newton-100 humanoid -- the same solve on the model
   that does not diverge, F = 8, lin_batch = 50 (400 lanes x 75 tangents
   a chunk), one replan: one solve timed by iLQR stage with the kernels,
   then the same fleet with the plain versions; every plan cost finite and below
   1e5, and the two runs' plan costs and controls equal to the bit.
14. slice: MPC torque consistency -- the executed controls of 4 lanes of
   phase 12 replayed for 100 steps in fp64 on the Newton-100 humanoid;
   forward + compare_fwd_inv at every visited state, solver_fwdinv <= 1e-6.
15. slice: integrators fleet -- phase 6's fleet (humanoid_mjx, B = 4096,
   fp32) stepped 20 times (step_n, after a warm-up step) under each of
   EULER, RK4, IMPLICIT and IMPLICITFAST, the integrator picked in the
   model snapshot's Mapping: steps/s, each kernel's launches a step, finite
   lanes, auto-resets; device time and busy share of 3 profiled RK4 steps;
   then 5 steps of 64 Newton-100 lanes (fp64, feet on the floor) under each
   new integrator with the kernels against 5 with the plain versions (<=
   1e-9).
16. slice: inverse_test -- the reference fork's src/inverse/inverse_test.cpp
   on the Newton-100 humanoid under RK4, 64 lanes fp64, 100 steps (the
   fork's 200 cut to half for time): fresh qfrc_applied, xfrc_applied and
   ctrl a step from a seeded torch.Generator at phase 7's scales, then
   forward + compare_fwd_inv (solver_fwdinv <= 1e-6 on every lane at every
   step), then the RK4 step.  Then the discrete inverse under IMPLICIT and
   IMPLICITFAST (INVDISCRETE): 20 steps of 64 lanes, each step's (qvel' -
   qvel) / h through inverse at the state stepped from gives back qfrc_applied
   + qfrc_actuator + Jᵀ xfrc_applied within 1e-6.
17. slice: sensors -- dm_control's humanoid with its 34 sensors
   (humanoid_sensors, Newton-100, nsensordata = 66) and the humanoid
   without them, B = 4096 fp32, feet on the floor, the same seeded states:
   20 steps (step_n, after a warm-up step) of each in one call, in turns
   sensors, plain, plain, sensors: steps/s of each, each kernel's launches
   a step, finite sensordata, touch sensors reading > 0; device launches
   and ms a step of 2 profiled steps of each, and of each part of the
   sensor stage profiled alone.  Then 5 steps of 64 lanes
   (fp64) with the kernels against 5 with the plain versions (sensordata,
   qpos, qvel within 1e-9); then transition_ad(flg_sensor=True) of 8 lanes
   (fp64, Euler): C (8, 66, 54) and D (8, 66, 21) with the kernels against
   the plain versions (<= 1e-9) and against transition_fd (centered, eps
   1e-6, from a zero warm start, as C's mjd_transitionFD after mj_forward)
   within 1e-4 of max|C| and max|D|.
18. slice: constraint rows -- equality (connect, weld, joint), dof
   friction-loss and ball-limit rows, with mocap, on the six models of
   assets/ (the BASELINE rung-1 slider crank, eq_joint, weld, limited,
   frictionloss, mocap_weld): each at B = 4096 fp32, 20 steps (step_n,
   after a warm-up step): steps/s, finite lanes, each kernel's launches a
   step; the primal kernels timed at (4096, 3) and (4096, 5) fp32 against
   the plain versions, the library calls and the bound.  Then the fork's
   inverse_test on the slider crank under RK4, 64 lanes fp64, 250 steps
   of 0.002 s (the fork's 1 s cut to half for time): fresh qfrc_applied,
   xfrc_applied and ctrl a step from a seeded torch.Generator at phase
   16's scales, forward +
   compare_fwd_inv (both solver_fwdinv entries <= 1e-6 on every lane at
   every step), the RK4 step.  Then each model's 5 steps of 64 lanes fp64
   with the kernels against 5 with the plain versions (qpos, qvel,
   efc_force within 1e-9), and transition_ad of 8 slider-crank lanes
   (fp64) against the plain versions (<= 1e-9) and transition_fd
   (centered, eps 1e-6, zero warm start; within 1e-4 of max|A|).
19. slice: tendons -- activation dynamics, muscles and tendons on the three
   models of assets/ (tendon_arm, BASELINE rung 2's muscle arm on arm26's
   pattern; actuated; tendon_rows): each at B = 4096 fp32, 20 steps
   (step_n, after a warm-up step), random controls within ctrlrange, the
   tendon arm under EULER, RK4, IMPLICIT and IMPLICITFAST: steps/s, finite
   lanes, each primal kernel's launches a step; the primal kernels timed
   at (4096, 2) fp32.  Then the fork's inverse_test on the tendon arm under
   RK4, 64 lanes fp64, 60 steps (0.3 s, cut for time) of fresh
   qfrc_applied, xfrc_applied and ctrl from a seeded torch.Generator (both
   solver_fwdinv entries <= 1e-6 on every lane at every step).  Then
   BASELINE rung 2: iLQR reach on the tendon arm, F = 64 fp32 problems,
   H = 25 (50 until phase 27), ILQRConfig(iterations=2) (10 took 272 s:
   cut for time),
   a seeded reachable target per lane, cost |hand - target|^2 + 1e-3 |u|^2
   (the hand from the arm's closed-form planar kinematics): solves/s,
   finite lanes, the median hand-target distance at the start and at the
   plan's end (it must fall); then 4 lanes fp64, 1 iteration, with the
   kernels against the plain versions (plan costs within 1e-9 relative).
   Then each model's 5 steps of 64 lanes fp64 with the kernels against 5
   with the plain versions (qpos, qvel, act, efc_force within 1e-9), and
   transition_ad of 8 tendon-arm lanes (fp64; A 10 x 10, B 10 x 6) against
   the plain versions (<= 1e-9) and transition_fd (centered, eps 1e-6,
   zero warm start; within 1e-4 of max|A| and of max|B|).
20. slice: boxes and convex meshes -- box, plane-cylinder and convex-mesh
   collision (the SAT narrowphase over the hulls put_model builds) on the
   two models of assets/ (box_stack: three stacked boxes, a sphere, a
   capsule and a cylinder, nv 36; convex_mesh: a tetrahedron, an
   icosahedron, a box, a sphere and a capsule, nv 30): each at B = 4096
   fp32, 20 steps (step_n, after a warm-up step) under EULER from seeded
   states at rest in contact: steps/s, finite lanes, each primal kernel's
   launches a step, peak memory, active contacts a lane (mean, max); the
   collision stage's device ms and launches against those of 2 profiled
   steps; the primal kernels timed at each nv and dof-block size (4096
   lanes fp32).  Then each model's 5 steps of 64 lanes fp64 with the
   kernels against 5 with the plain versions (qpos, qvel, efc_force
   within 1e-9), and the fp32 contacts of the first and last of those
   states against the fp64 ones: each (lane, geom pair)'s active contacts
   the same, their depths within 1e-4.  Then the fork's inverse_test on
   box_stack under RK4, 64 lanes fp64, 60 steps of fresh qfrc_applied and
   xfrc_applied (both solver_fwdinv entries <= 1e-6 on every lane at every
   step), and transition_ad of 8 box-stack lanes (fp64) against the plain
   versions (<= 1e-9) and transition_fd (centered, eps 1e-6, zero warm
   start; within 1e-4 of max|A|).
21. slice: balance LQR -- BASELINE rung 3, the humanoid's one-leg balance
   (scripts/balance.py, the recipe of python/LQR.ipynb on the Newton-100
   humanoid) in fp64 on the card: the pose (right leg lifted, the body
   leaned over the left foot by Gauss-Newton, the root height of a
   2001-lane inverse sweep), ctrl0, A and B by transition_ad against
   transition_fd (centered, eps 1e-6; within 1e-4 of max|A|), the cost,
   and K, P = lqr_gain at scripts/balance.py's LQR_ITERATIONS (P's last
   relative change, K's change since half as many, and scipy's DARE on the
   host, which has no finite solution here); then a fleet of 4096 fp32
   lanes from the pose with 0.01 hinge and velocity noise, half closed
   loop (ctrl0 - K dx + smoothed control noise, in ctrl_fn) and half open
   loop (K = 0), 200 steps through opt.rollout: the share of each half
   balanced at every step (at least 0.9 closed loop, at most 0.5 open
   loop), steps/s, finite lanes, each half's auto-resets (none in the
   closed loop), launches; then 4 fp64 lanes for 25 closed-loop steps and 4 for
   10 open-loop steps from the inputs of assets/humanoid_balance_c.npz
   against C's runs in it (scripts/balance_c_reference.py: mjcb_control,
   mujoco.rollout.rollout; the card's machine has no mujoco), within
   1e-6, and the closed loop with the kernels against the plain versions
   (1e-9).
22. slice: contact models -- elliptic friction cones, explicit <pair>s and
   MJX's contact budget.  box_stack, convex_mesh, the Newton-100 humanoid
   (feet on the floor) and elliptic_pairs (condim 1, 3, 4 and 6, a <pair>
   with solreffriction) with opt_cone set to ELLIPTIC in the snapshot's
   Mapping: each at B = 4096 fp32, 5 EULER steps (step_n, after a warm-up
   step; 20 cut for time), and the same fleet under the pyramidal cone, in
   turns: steps/s
   and their ratio, rows, factorizations a step, finite lanes,
   auto-resets (none under the elliptic cone), and the share of active
   elliptic slots in the cone's middle zone (above 0 over the fleets, or
   the cone's force never ran).  Then each elliptic model's 5 steps of 64
   lanes fp64 with the kernels against 5 with the plain versions (qpos,
   qvel, efc_force within 1e-9); the fork's inverse_test on elliptic
   box_stack (RK4, 64 lanes fp64, 12 steps of fresh forces (60 cut for
   time), solver_fwdinv
   <= 1e-6; its second entry, the forward solve's residual, only where the
   Newton solve met its gradient test: the others are counted); transition_ad of 8 sliding elliptic box-stack lanes (fp64,
   middle-zone slots present) against the plain versions (<= 1e-9) and
   transition_fd (centered, eps 1e-6, zero warm start; within 1e-4 of
   max|A|).  Last, sphere_budget (20 free spheres, max_geom_pairs 24,
   max_contact_points 12) against the same scene without the numerics
   (210 slots), 4096 fp32 lanes x 20 steps each: slots a lane, finite
   lanes, steps/s.

23. slice: quadruped and terrain -- cylinder and ellipsoid collision (the
   support-function descent of ops/ccd.py) and height fields, on
   dm_control's quadruped as the walk and fetch tasks build it
   (quadruped, quadruped_fetch: an ellipsoid torso, cylinder eyes, capsule
   legs, sphere toes, the fetch ball with condim 6) and on free spheres,
   capsules, a box and a convex mesh over the escape task's terrain
   (terrain_objects): each at B = 4096 fp32, 20 EULER steps (step_n, after
   a warm-up step) from states the way the tasks start them (a random
   orientation, the body lowered onto the floor or the terrain, controls
   uniform in ctrlrange): steps/s, factorizations a step, finite lanes,
   auto-resets, active contact slots a lane, peak memory; the collision
   stage's device ms and launches against those of 2 profiled steps; the
   primal kernels timed at n = 22 and 28.  Then the fp32 contacts of 64
   states against the fp64 ones (each (lane, pair)'s active set equal,
   depths within 1e-4; a hull on the height field by its deepest
   contact), each model's 5 steps of 64 lanes fp64 with the kernels
   against 5 with the plain versions (within 1e-9), the fork's
   inverse_test on quadruped_fetch (RK4, 64 lanes fp64, 20 steps of fresh
   forces, solver_fwdinv <= 1e-6), and transition_ad of 8 fetch lanes,
   upright with the ball on the torso (an ellipsoid-sphere descent pair),
   against the plain versions (<= 1e-9) and transition_fd (centered, eps
   1e-6, zero warm start; within 1e-4 of max|A|).

24. slice: solvers, fluid and energy -- the CG and PGS solvers, the noslip
   pass, fluid forces and the ENERGY flag: dm_control's swimmer15 and fish
   (the inertia-box fluid), acrobot and cartpole (under their own RK4) and
   pendulum (ENERGY on), each at B = 4096 fp32, 20 steps (step_n, after a
   warm-up step) from states the way their tasks start them; the
   Newton-100 humanoid under CG and under Newton in turns (5 steps each),
   under PGS (1 step), box_stack under PGS with noslip_iterations 4 (1
   step) and elliptic_pairs under Newton with noslip 4 (2 steps): steps/s,
   finite lanes, auto-resets (none), launches a step, peak memory, the
   solver's iterations or sweeps and the noslip sweeps a solve, d.energy
   finite; the fluid forces' device ms and launches against those of 2
   profiled swimmer15 steps; chol_solve at (4096, 27) x 324 and (4096, 36)
   x 164 columns and at box_stack's (6 x 4096, 6) x 164 against its plain
   version, torch.cholesky_solve and its bound, the primal kernels at n =
   17 and 13.  Then each configuration's fp64 steps of 64 lanes with the
   kernels against the plain versions (qpos, qvel, efc_force, energy within
   1e-9; 5 steps, the PGS ones 2), the fork's inverse_test on swimmer15
   (RK4, 64 lanes fp64, 20 steps of fresh forces, solver_fwdinv <= 1e-6),
   and transition_ad of 8 swimmer15 lanes under EULER and IMPLICIT against
   the plain versions (<= 1e-9) and transition_fd (centered, eps 1e-6, zero
   warm start; within 1e-4 of max|A|).

25. slice: flex -- the flex scenes of the JAX package's tests
   (``scripts/flex_models.py``): a cloth with stretch elasticity (20
   steps), a sheet with edge rows under a sphere, a capsule, a box, a
   mesh, a cylinder and an ellipsoid, a tet cube with a box on it, a
   folded sheet (self-collision) and a trilinear cube with a sphere on it
   (5 steps each), B = 4096 fp32 from seeded states at rest in contact
   (``flex_data``): steps/s, finite lanes, auto-resets (none), active
   slots a lane, launches a step, peak memory, and the flex collision's
   device ms and launches against a step's; the kernels timed at the
   scenes' nv, the JVP kernels at transition_ad's shapes (fp64).  Then
   the fp32 contacts of 64 states against fp64 (closed forms: active sets
   equal, depths within 1e-4; the descent groups and the box's SAT
   manifold on the tets: each lane's deepest contact within 1e-4), the
   fork's inverse_test on flex_sheet_sphere (RK4, 64 lanes fp64, 20 steps
   of fresh forces of 0.01 randn, solver_fwdinv <= 1e-6) and
   transition_ad of 8 lanes of
   flex_cloth and flex_sheet_box against the plain versions (<= 1e-9) and
   transition_fd (centered, eps 1e-6, zero warm start; within 1e-4 of
   max|A|).

26. slice: sensor tail -- the rest of the sensors, the scene ray cast and
   the SITE, SLIDERCRANK and BODY (adhesion) transmissions.
   quadruped_rangefinder (dm_control's quadruped with the escape task's 32
   sensors, 20 of them rangefinders, on the walk task's floor) and phase
   23's quadruped from the same walk-task starts, B = 4096 fp32, 20 EULER
   steps (step_n, after a warm-up step) each, in turns rangefinder, plain,
   plain, rangefinder: steps/s of each and their ratio, finite lanes,
   auto-resets, the rangefinders hitting and reading -1, each kernel's
   launches a step; the sensor stage's and the rangefinder cast's device
   ms and launches against those of 2 profiled steps with rangefinders; the three transmission scenes
   (scripts/sensor_tail_models.py: a slider-crank, a site with a reference
   site, adhesion) at B = 4096 fp32, 20 steps: steps/s, finite lanes, the
   share of adhesion lanes whose sphere stays on the floor; the kernels
   timed at (4096, 22) fp32 and the JVP kernels at (8 lanes, 68 tangents,
   22) fp64.  Then the fp32 rangefinders of 64 states against fp64 (the
   same geom hit, distances within 1e-4 m, rays grazing a silhouette
   counted, at most 2%); 64 lanes fp64, 5 steps of quadruped_rangefinder,
   the transmission scenes and the sensor-tail scenes (sensor_tail,
   sensor_cams, sensor_limits) with the kernels against 5 with the plain
   versions (qpos, qvel, sensordata, actuator_length within 1e-9); and
   transition_ad(flg_sensor=True) of 8 upright quadruped_rangefinder lanes
   standing on their toes (fp64, EULER): C (8, 56, 56) and D (8, 56, 12)
   against the plain versions (<= 1e-9) and transition_fd (centered, eps
   1e-6, zero warm start; within 1e-4 of max|C|, of max|D| and of the
   largest of C's rangefinder rows).
27. slice: plugins -- the engine plugins (PID, cable, touch grid) and the
   SDF plugin geoms (the torus, the bowl, the mesh-SDF cube), the JAX
   package's tests' scenes (scripts/plugin_models.py): each at B = 4096
   fp32 from seeded states (the SDF scenes' free body resting on its SDF),
   20 steps (the SDF scenes 5: each runs the clearance descent): steps/s,
   finite lanes, auto-resets, each kernel's launches a step, peak memory,
   a step's device ms and launches and, on the SDF scenes, collision's
   against them; the kernels timed at (4096, n) fp32 for the scenes' nv
   and the JVP kernels at (6, 8 lanes, 12 tangents) fp64.  Then 64 lanes
   fp64, 5 steps of each scene with the kernels against 5 with the plain
   versions (<= 1e-9); the fp32 deepest SDF contact of 64
   states against fp64 (<= 1e-4); the touch grid's fp32 readings against
   fp64 (each channel's taxel sum within 1e-4 of its scale, each contact
   clear of a bin edge by 1e-5 rad in the same taxel); the fork's
   inverse_test on the cable (EULER: RK4 diverges on it, in C too) and the
   bowl (RK4), 64 lanes fp64 x 20 steps; transition_ad of 8 lanes of the
   sphere resting on the torus (fp64) against the plain versions and
   transition_fd (centered, eps 1e-6; within 1e-4 of max|A|).
28. slice: tools -- the tools around the engine on the Newton-100
   humanoid (assets/humanoid.npz): system identification by
   opt.least_squares, 1024 fp32 lanes of phase 6's states raised 0.1 m,
   each with hidden controls u* in the middle 80% of ctrlrange, fitted
   from u = 0 within ctrlrange (20 iterations at most): lanes within 1e-3
   of the range of u*, finite lanes, iterations, seconds, launches; the
   kernels timed at (1024, 27) fp32 and the JVP kernels at (1024 lanes,
   21 tangents, 27) fp32; mpc_weak_scaling's point on the cards present
   (8 lanes a card, H = 10; one card: efficiency not measurable).  Then,
   under torch's deterministic algorithms: the fp64 fit of 8 lanes with
   no constraint row within 1e-8 of the range of u*, kernels against
   plain versions (<= 1e-12); a fleet MPC (F = 8, H = 10, fp32) saved
   after one cycle, restored onto the card and resumed, bit-equal to two
   cycles; the sharded fleet step of 4096 lanes and the sharded fleet MPC
   bit-equal to the unsharded ones; names and a keyframe from the
   snapshots on CUDA tensors; a printer dump of the model and one lane
   (chiprun_out/tools_dump.txt); the band solvers at (64, 270, 27) fp64
   against the dense factor (<= 1e-9).

Phase 10 also runs transition_ad of the Newton-100 humanoid under RK4 and
IMPLICIT (the qDeriv Jacobian nested in the dual step).  Every kernel
launch of phases 6-28 must be at a shape phase 9 checked: (n, lanes,
dtype) of the factor, (n, lanes, columns, dtype) of the solve, (n, lanes,
tangents, dtype) of the factor's JVP, (n, lanes, tangents, columns,
dtype) of the solve's.  Then
one JSON line of the kernel report (launches: the sum over the main paths,
phases 6, 12, 15, 16, 17, 18, 19, 20, 21 (its transition_ad and its
fleet), 22-28, each read with the counts reset before it, in
either process;
by path beside it; the JVP kernels with the tangent counts of their phase 12
launches), the nvidia-smi line, and the result line.  There is no CPU path: without
CUDA the script fails.  It imports neither jax nor mujoco: the models
come from the model snapshots in the package's assets/.

    python3 chip_smoke.py --bench

runs only the build and phase 12 at the bench configuration (``bench.py``'s
north-star cell: F = 512, H = 100, lin_batch = 2, one replan, n_apply = 1),
then one more solve of that fleet timed by iLQR stage, and the same two
for the Newton-100 humanoid.

    python3 chip_smoke.py --fleet

runs only the build and phase 6, to compare the fleet step of two
checkouts: run this file from each, in turns.

    python3 chip_smoke.py --convex

runs only the build and phase 20, and

    python3 chip_smoke.py --lqr

only the build and phase 21,

    python3 chip_smoke.py --contact

only the build and phase 22, and

    python3 chip_smoke.py --shapes

only the build and phase 23 (both its timed and its check parts), and

    python3 chip_smoke.py --suite

only the build and phase 24 (both parts), and

    python3 chip_smoke.py --flex

only the build and phase 25 (both parts), and

    python3 chip_smoke.py --tail

only the build and phase 26 (both parts), and

    python3 chip_smoke.py --plugins

only the build and phase 27 (both parts), and

    python3 chip_smoke.py --tools

only the build and phase 28 (both parts).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "mujoco_inversedynamicstest_tpu_torch/csrc/cholesky.cu"
# the JVP kernels replace what pallas_call's JVP rule derives from the same
# kernel bodies
REPLACES = {
    "chol_factor": "mujoco_inversedynamicstest_tpu/ops/linalg.py:63",
    "chol_solve": "mujoco_inversedynamicstest_tpu/ops/linalg.py:86",
    "chol_factor_jvp": "mujoco_inversedynamicstest_tpu/ops/linalg.py:63",
    "chol_solve_jvp": "mujoco_inversedynamicstest_tpu/ops/linalg.py:86",
}
KERNELS = tuple(REPLACES)
# (fleet, lin_batch, n_apply) of the MPC phases 12 and 13, and of --bench
MPC_HORIZON = 100
# phase 12: F cut from 64 to 32, then to 16, and phase 13's from 16 to 8,
# to keep the script in its time (phase 25 added)
MPC_RUN, MPC_REF_RUN, MPC_BENCH = (16, 20, 100), (8, 50, 1), (512, 2, 1)
BENCH_CHUNK_LANES = 1024  # 512 x 2: the bench chunk, 75 tangents a lane
FLEET, FLEET_STEPS = 4096, 100
INTEGRATORS, INTEGRATOR_STEPS = ("EULER", "RK4", "IMPLICIT",
                                 "IMPLICITFAST"), 20
# the fork's inverse_test steps 1 s at 0.005 s; half of it, for time
INVERSE_TEST_STEPS, RECOVERY_STEPS = 100, 20
SENSOR_STEPS = 20
# phase 18: the models of the constraint rows, their fleet steps, and the
# fork's inverse_test on the slider crank: the fork steps 1 s at 0.002 s,
# 500 steps, over a minute on an H100; half of it, for time
CONSTRAINT_MODELS = ("slider_crank", "eq_joint", "weld", "limited",
                     "frictionloss", "mocap_weld")
CONSTRAINT_STEPS, CRANK_INVERSE_STEPS = 20, 250
# phase 19: the tendon slice's models, the fork's inverse_test on the tendon
# arm, and BASELINE rung 2 (iLQR reach, F problems at horizon H)
TENDON_MODELS = ("tendon_arm", "actuated", "tendon_rows")
# the arm's inverse_test steps 0.3 s of 0.005 s, and the reach iLQR takes
# 2 iterations (10 took 272 s, 27-47 s each on an H100 by its host):
# cut for time
TENDON_STEPS, ARM_INVERSE_STEPS = 20, 60
# F cut from 256 to 128 to make room for phase 25, and to 64 for phase 26;
# H from 50 steps (0.25 s) to 25 for phase 27: the reach is host-bound, its
# time the backward passes of the regularization's escalation (18 at H =
# 50, 8 at H = 25 on the CPU), and took 121.6 s of phase 19's 140.7 at H =
# 50 on an H100; the hand still closes on its target (the CPU rehearsal:
# median 0.231 m to 0.064 m at H = 25, 0.085 m at H = 50)
REACH_F, REACH_H, REACH_ITERATIONS, REACH_ALPHAS = 64, 25, 2, 8
REACH_CHECK_LANES, REACH_CHECK_ITERATIONS = 4, 1
# phase 20: the convex slice's models (boxes, a cylinder on the plane,
# convex meshes), their fleets, and the fork's inverse_test on the box stack
# (60 steps of 0.002 s, as phase 19's arm, for time)
CONVEX_MODELS = ("box_stack", "convex_mesh")
CONVEX_STEPS, BOX_INVERSE_STEPS = 20, 60
# phase 21: BASELINE rung 3, the humanoid's one-leg balance LQR
# (scripts/balance.py): the fleet of B lanes, half closed loop and half open
# loop, for T steps (1 s; the notebook's 5 s run is cut for time, to 2 s,
# to 1.25 s for phase 25 and to 1 s for phase 26: open loop falls within 1
# s); the sweep's lanes; the fp64 C reference's lanes and steps
BALANCE_FLEET, BALANCE_STEPS, BALANCE_SEED = 4096, 200, 21
BALANCE_SWEEP, BALANCE_C_LANES = 2001, 4
BALANCE_REFERENCE = "humanoid_balance_c.npz"
# phase 22: the contact models -- elliptic cones on the convex slice's
# models, the Newton-100 humanoid and elliptic_pairs (each fleet beside the
# same under the pyramidal cone), the fork's inverse_test and
# transition_ad on elliptic box_stack, and MJX's contact budget
# (sphere_budget against the same scene without its numerics).  With the
# elliptic fleets' 20 steps and the inverse_test's 60 the phase took 158.7
# s of its 90 s on an H100, with 10 and 20 119.1 s on a slower host: cut to
# 5 and 12 for time
CONTACT_MODELS = ("box_stack", "convex_mesh", "humanoid", "elliptic_pairs")
CONTACT_STEPS, CONTACT_INVERSE_STEPS, BUDGET_STEPS = 5, 12, 20
# phase 23: dm_control's quadruped (walk and fetch) and free objects on the
# escape task's terrain (cylinder and ellipsoid collision, height fields):
# their fleets, the fork's inverse_test on the fetch model (RK4, 20 steps of
# fresh forces) and transition_ad with the ball on the torso
SHAPES_MODELS = ("quadruped", "quadruped_fetch", "terrain_objects")
SHAPES_STEPS, FETCH_INVERSE_STEPS = 20, 20
# phase 24: the solvers, fluid forces and energy -- dm_control's swimmer15
# and fish (fluid), acrobot, cartpole and pendulum (ENERGY, the first two
# under their own RK4), each fleet SUITE_STEPS steps; the Newton-100
# humanoid under CG beside Newton in turns and under PGS, box_stack under
# PGS with noslip, elliptic_pairs under Newton with noslip, each fleet the
# steps beside it; the fork's inverse_test on swimmer15 and transition_ad
# of 8 swimmer15 lanes under EULER and IMPLICIT
SUITE_MODELS = ("swimmer15", "fish", "acrobot", "cartpole", "pendulum")
SUITE_STEPS, SWIMMER_INVERSE_STEPS = 20, 20
# noslip_iterations="4": dm_control's dog's
NOSLIP_ITERATIONS = 4
# (model, solver, noslip iterations, timed steps, checked fp64 steps): the
# PGS fleets' 3 timed steps and the noslip fleet's 5 cut to 1, 1 and 2, and
# the PGS fleets' 5 fp64 steps to 2, for the phase's time (PERF.md §4)
SOLVER_FLEETS = (("humanoid", "CG", 0, 5, 5), ("humanoid", "NEWTON", 0, 5, 5),
                 ("humanoid", "PGS", 0, 1, 2),
                 ("box_stack", "PGS", NOSLIP_ITERATIONS, 1, 2),
                 ("elliptic_pairs", "NEWTON", NOSLIP_ITERATIONS, 2, 5))
# phase 25: the flex scenes of the JAX package's tests (scripts/
# flex_models.py), each fleet FLEX_STEPS steps (the cloth 20); the fork's
# inverse_test on flex_sheet_sphere; transition_ad of the cloth and of the
# box on the sheet
FLEX_SCENES = ("flex_cloth", "flex_sheet_sphere", "flex_sheet_capsule",
               "flex_sheet_box", "flex_sheet_mesh", "flex_sheet_cylinder",
               "flex_sheet_ellipsoid", "flex_tet_box", "flex_self",
               "flex_trilinear")
FLEX_STEPS, CLOTH_STEPS, FLEX_INVERSE_STEPS = 5, 20, 20
# the solid cubes lowered onto the plane, 1 mm into it (the tet cube's
# bottom vertices at 0.15, radius 0.005; the trilinear cube's at 0.06)
FLEX_DROP = {"flex_tet_box": 0.146, "flex_trilinear": 0.056}
# the free body's height in each scene's states: 1 mm into the sheet (at
# z = 0, radius 0.008) or the lowered cube's top (the tet cube's vertices
# at 0.25 - 0.146, the trilinear one's at 0.26 - 0.056, radius 0.005), by
# its half-height below its centre
FLEX_REST = {"flex_sheet_sphere": 0.022, "flex_sheet_capsule": 0.017,
             "flex_sheet_box": 0.017, "flex_sheet_mesh": 0.019,
             "flex_sheet_cylinder": 0.017, "flex_sheet_ellipsoid": 0.011,
             "flex_tet_box": 0.118, "flex_trilinear": 0.228}
# the nv of the flex scenes, whose kernels phase 25 times: flex_trilinear,
# flex_cloth, the sheets, flex_self, flex_tet_box
FLEX_NV = (30, 42, 69, 75, 87)
# phase 26: the sensor tail and the transmissions -- dm_control's quadruped
# with its 20 rangefinders (the escape task's sensors on the walk task's
# floor) beside phase 23's quadruped, in turns, RANGEFINDER_STEPS steps a
# run; the three transmission scenes' fleets; the sensor-tail scenes
# (scripts/sensor_tail_models.py) in the checks
RANGEFINDER_STEPS, TRANSMISSION_STEPS = 20, 20
TRANSMISSION_SCENES = ("transmission_slidercrank", "transmission_refsite",
                       "transmission_adhesion")
TAIL_SCENES = ("sensor_tail", "sensor_cams", "sensor_limits")
# the fp32 rays of 64 states that may hit another geom than fp64's (a ray
# grazing a silhouette): at most this share
GRAZE_SHARE = 0.02
# phase 27: the engine-plugin and SDF-plugin scenes of the JAX package's
# tests (scripts/plugin_models.py): each fleet PLUGIN_STEPS steps (the SDF
# scenes SDF_STEPS: each step runs the clearance descent); the fork's
# inverse_test on the cable and the bowl; transition_ad of the sphere
# resting on the torus
PLUGIN_SCENES = ("plugin_cable", "plugin_pid", "plugin_touch_grid")
SDF_SCENES = ("sdf_torus", "sdf_torus_pair", "sdf_bowl", "sdflib_cube")
PLUGIN_STEPS, SDF_STEPS, PLUGIN_INVERSE_STEPS = 20, 5, 20
# the scenes' nv: the cable's, the PID's hinge, the touch grid's slides,
# the free bodies of the SDF scenes
PLUGIN_NV = (21, 1, 2, 6)
GRID_N, GRID_B = (1, 2, 6, 27, 32, 33, 64, 128), (1, 127, 4096)
# phase 28: the system identification's fleet, iterations and the
# height its states are raised off the floor (at contact or at a joint
# limit the soft rows absorb part of each actuator's force and Gauss-Newton
# can stall short of u*: the CPU rehearsal); the MPC of the checkpoint,
# sharding and weak-scaling checks; the band solvers' (B, ntotal, nband)
SYSID_LANES, SYSID_ITERS, SYSID_RAISE = 1024, 20, 0.1
TOOLS_MPC_FLEET, TOOLS_MPC_HORIZON = 8, 10
BAND = (64, 270, 27)
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}  # of max|reference|
# NVIDIA's H100 SXM data sheet: memory rate, and fp32 and fp64 outside
# tensor cores
HBM_BYTES_PER_S, FP32_FLOP_PER_S, FP64_FLOP_PER_S = 3.35e12, 67e12, 34e12


T_START = time.perf_counter()
# which parts of each phase this process runs: a full run runs the timed
# fleets, solves and kernel timings here, and the untimed fp64 checks in a
# second process on the same card (``--checks``); a run of one phase runs
# both
TIMED = CHECKS = True


def log(phase: str, msg: str) -> None:
  """One line of the run's log, after the seconds since the script began."""
  print(f"{time.perf_counter() - T_START:7.1f} s [{phase}] {msg}", flush=True)


class _Tee:
  """A stream that writes to the terminal and to a file."""

  def __init__(self, stream, file):
    self.stream, self.file = stream, file

  def write(self, text: str) -> int:
    self.file.write(text)
    return self.stream.write(text)

  def flush(self) -> None:
    self.file.flush()
    self.stream.flush()


def tee_log(path: str) -> None:
  """Copies everything this process prints, the checks process's lines and
  any traceback among it, into ``path`` as well: the whole log, where a
  caller keeps only the end of the output."""
  os.makedirs(os.path.dirname(path), exist_ok=True)
  file = open(path, "w", buffering=1)
  sys.stdout = _Tee(sys.stdout, file)
  sys.stderr = _Tee(sys.stderr, file)


def nvidia_smi() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
      check=True)
  return out.stdout.strip().splitlines()[0]


def spd(rng: np.random.Generator, b: int, n: int, dev) -> torch.Tensor:
  """SPD matrices with condition number <= 1e3 (Gershgorin bound):
  G Gᵀ + (R / 999) I, R the largest absolute row sum of G Gᵀ."""
  g = torch.as_tensor(rng.standard_normal((b, n, n)), device=dev)
  h = g @ g.transpose(1, 2)
  r = h.abs().sum(-1).amax(-1)
  return h + (r / 999.0)[:, None, None] * torch.eye(n, device=dev,
                                                     dtype=h.dtype)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
  if not bool(torch.isfinite(x).all()):
    raise AssertionError("non-finite kernel output")
  if x.shape != ref.shape:
    raise AssertionError(f"kernel output {tuple(x.shape)}, "
                         f"expected {tuple(ref.shape)}")
  return float((x - ref).abs().max() / ref.abs().max().clamp(min=1e-300))


def bound_ms(nbytes: float, flops: float,
             fp64: bool = False) -> tuple[float, str]:
  """The least time the card could take: each input byte read once and each
  output byte written once at the memory rate, or the operations at the
  fp32 (``fp64``: fp64) rate, whichever is longer."""
  t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
  t_ops = 1e3 * flops / (FP64_FLOP_PER_S if fp64 else FP32_FLOP_PER_S)
  return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PLAIN = {"_factor": "chol_factor_ref", "_solve": "chol_solve_ref",
         "chol_factor_jvp": "chol_factor_jvp_ref",
         "chol_solve_jvp": "chol_solve_jvp_ref"}


@contextlib.contextmanager
def plain_cholesky(linalg):
  """Puts the plain versions in the kernels' place behind chol_factor /
  chol_solve and their forward-mode rules, so the same run can be
  repeated without the kernels on the card."""
  saved = {k: getattr(linalg, k) for k in PLAIN}
  for k, plain in PLAIN.items():
    setattr(linalg, k, getattr(linalg, plain))
  try:
    yield
  finally:
    for k, fn in saved.items():
      setattr(linalg, k, fn)


def check_kernel(name: str, got: torch.Tensor, ref: torch.Tensor,
                 case: str) -> float:
  """Holds a kernel's output to its plain version's: within TOL of
  max|reference|, and then equal to the bit (the kernels do the plain
  versions' operations in the same order, csrc/cholesky.cu).  Returns the
  relative error."""
  e = rel_err(got, ref)
  if e > TOL[ref.dtype]:
    raise AssertionError(f"{name} {case}: rel err {e:.3e}")
  if not torch.equal(got, ref):
    raise AssertionError(f"{name} {case}: within tolerance ({e:.3e}) but "
                         "not bit-equal to the plain version")
  return e


def check_kernels(linalg, dev) -> dict:
  """Phases 3 and 4; returns the max abs error at the slice's shape."""
  rng = np.random.default_rng(0)
  worst = {"chol_factor": 0.0, "chol_solve": 0.0}
  slice_err = {}
  for n in GRID_N:
    for b in GRID_B:
      h64 = spd(rng, b, n, dev)
      rhs64 = torch.as_tensor(rng.standard_normal((b, n, 3)), device=dev)
      for dt in (torch.float32, torch.float64):
        h, rhs = h64.to(dt), rhs64.to(dt)
        l_ref = linalg.chol_factor_ref(h)
        l = linalg.chol_factor(h)
        case = f"n={n} B={b} {dt}"
        worst["chol_factor"] = max(worst["chol_factor"], check_kernel(
            "chol_factor", l, l_ref, case))
        for r in (rhs[..., 0], rhs):
          worst["chol_solve"] = max(worst["chol_solve"], check_kernel(
              "chol_solve", linalg.chol_solve(l_ref, r),
              linalg.chol_solve_ref(l_ref, r), f"{case} rhs{tuple(r.shape)}"))
        if n == 27 and b == FLEET and dt == torch.float32:
          slice_err["chol_factor"] = float((l - l_ref).abs().max())
          slice_err["chol_solve"] = float(
              (linalg.chol_solve(l_ref, rhs[..., 0])
               - linalg.chol_solve_ref(l_ref, rhs[..., 0])).abs().max())

  # asymmetric input: the kernel reads true columns (the lower triangle)
  n, b = 27, 128
  a = torch.as_tensor(rng.standard_normal((n, n)), device=dev)
  h = a @ a.T + 3.0 * torch.eye(n, device=dev, dtype=a.dtype)
  noise = torch.triu(torch.as_tensor(rng.standard_normal((n, n)),
                                     device=dev), 1)
  h_asym = (h + 1e-3 * noise).expand(b, n, n).contiguous()
  h_lower = torch.tril(h_asym) + torch.tril(h_asym, -1).transpose(1, 2)
  check_kernel("chol_factor", linalg.chol_factor(h_asym),
               linalg.chol_factor_ref(h_lower), "asymmetric input")

  # non-SPD input: the last pivot is negative and gets clamped
  for dt in (torch.float32, torch.float64):
    hn = spd(rng, 127, 27, dev).to(dt)
    hn[:, -1, -1] -= 1e3 * hn[:, -1, -1]
    check_kernel("chol_factor", linalg.chol_factor(hn),
                 linalg.chol_factor_ref(hn), f"non-SPD input {dt}")

  # non-contiguous inputs: transposed views of a stack and of a rhs
  h_t = spd(rng, 127, 27, dev).float().transpose(1, 2)
  l_t = linalg.chol_factor_ref(h_t)
  rhs_t = torch.as_tensor(rng.standard_normal((127, 3, 27)),
                          device=dev).float().transpose(1, 2)
  check_kernel("chol_factor", linalg.chol_factor(h_t), l_t,
               "non-contiguous input")
  check_kernel("chol_solve", linalg.chol_solve(l_t, rhs_t),
               linalg.chol_solve_ref(l_t, rhs_t), "non-contiguous input")

  log("kernel: chol_factor",
      f"{len(GRID_N) * len(GRID_B) * 2} cases n={GRID_N} B={GRID_B} "
      f"fp32/fp64 + asymmetric + non-SPD + non-contiguous: all bit-equal "
      f"to the plain version; max rel err {worst['chol_factor']:.3e} (tol "
      f"fp32 1e-4, fp64 1e-12)")
  log("kernel: chol_solve",
      f"{len(GRID_N) * len(GRID_B) * 4} cases, rhs (B,n) and (B,n,3), + "
      f"non-contiguous: all bit-equal to the plain version; max rel err "
      f"{worst['chol_solve']:.3e} (tol fp32 1e-4, fp64 1e-12)")
  return slice_err


def sym(rng: np.random.Generator, shape, dev) -> torch.Tensor:
  """Symmetric random matrices: a tangent of a symmetric matrix."""
  g = torch.as_tensor(rng.standard_normal(shape), device=dev)
  return g + g.transpose(-1, -2)


def lane_major(t: torch.Tensor) -> torch.Tensor:
  """(T, B, ...) with the lanes in front in memory: the other layout vmap
  can hand over."""
  return t.transpose(0, 1).contiguous().transpose(0, 1)


def factor_jvp_cases(linalg, l, dh):
  """(case, kernel output, plain output) of chol_factor_jvp for a lane
  stack l (B, n, n) and T tangents dh (T, B, n, n): tangent-major and
  lane-major, one tangent for all (a tangent stride of 0), and the
  single-tangent call (no T)."""
  return [(name, linalg.chol_factor_jvp(l, d), linalg.chol_factor_jvp_ref(
      l, d)) for name, d in (("tangent-major", dh),
                             ("lane-major", lane_major(dh)),
                             ("stride-0", dh[:1].expand(dh.shape)),
                             ("single", dh[0]))]


def solve_jvp_cases(linalg, l, dl, x, db):
  """The same for chol_solve_jvp, x (B, n[, k]) and T tangents dl, db:
  both layouts, either tangent the same for all or absent, and the
  single-tangent call."""
  cases = (("tangent-major", dl, db),
           ("lane-major", lane_major(dl), lane_major(db)),
           ("dL stride-0", dl[0], db), ("db stride-0", dl, db[0]),
           ("dL absent", None, db), ("db absent", dl, None),
           ("single", dl[0], db[0]))
  return [(name, linalg.chol_solve_jvp(l, a, x, b),
           linalg.chol_solve_jvp_ref(l, a, x, b)) for name, a, b in cases]


# (B, T) of the phase 8 grid: every B of the primal grid with one tangent,
# and a few lanes with 3 and 75 tangents a lane
JVP_GRID = tuple((b, 1) for b in GRID_B) + ((1, 3), (127, 3), (1, 75),
                                            (127, 75))


def check_jvp_kernels(linalg, dev) -> dict:
  """Phase 8; returns the max abs error at (1024 lanes, 75 tangents, 27)
  fp32, the bench's linearization chunk."""
  rng = np.random.default_rng(3)
  worst = {"chol_factor_jvp": 0.0, "chol_solve_jvp": 0.0}
  ncase = {"chol_factor_jvp": 0, "chol_solve_jvp": 0}

  def check(name, got, ref, case):
    worst[name] = max(worst[name], check_kernel(name, got, ref, case))
    ncase[name] += 1
    return float((got - ref).abs().max())

  for n in GRID_N:
    for b, t in JVP_GRID:
      h64, dh64 = spd(rng, b, n, dev), sym(rng, (t, b, n, n), dev)
      x64 = torch.as_tensor(rng.standard_normal((b, n, 3)), device=dev)
      db64 = torch.as_tensor(rng.standard_normal((t, b, n, 3)), device=dev)
      for dt in (torch.float32, torch.float64):
        h, dh, x, db = (v.to(dt) for v in (h64, dh64, x64, db64))
        l = linalg.chol_factor_ref(h)
        case = f"n={n} B={b} T={t} {dt}"
        cases = factor_jvp_cases(linalg, l, dh)
        for name, got, ref in cases:
          check("chol_factor_jvp", got, ref, f"{case} {name}")
        dl = cases[0][2]  # the plain JVP of the tangent-major dh
        for xr, dbr in ((x[..., 0], db[..., 0]), (x, db)):
          for name, got, ref in solve_jvp_cases(linalg, l, dl, xr, dbr):
            check("chol_solve_jvp", got, ref,
                  f"{case} {name} rhs{tuple(xr.shape)}")

  # clamped pivots pass no tangent: a negative pivot mid-way, on a dof
  # coupled to no other (so the factor stays finite), and at the end
  for dt in (torch.float32, torch.float64):
    hn = spd(rng, 127, 27, dev).to(dt)
    hn[:, 13, :] = 0.0
    hn[:, :, 13] = 0.0
    hn[:, 13, 13] = -1.0
    hn[:, -1, -1] -= 1e3 * hn[:, -1, -1]
    l = linalg.chol_factor_ref(hn)
    dh = sym(rng, (3, 127, 27, 27), dev).to(dt)
    got = linalg.chol_factor_jvp(l, dh)
    check("chol_factor_jvp", got, linalg.chol_factor_jvp_ref(l, dh),
          f"clamped pivots {dt}")
    if not (bool((got[..., 13, 13] == 0).all())
            and bool((got[..., -1, -1] == 0).all())):
      raise AssertionError("a clamped pivot got a tangent")

  # asymmetric tangents: only their lower triangles are read
  l = linalg.chol_factor_ref(spd(rng, 128, 27, dev))
  dh = torch.as_tensor(rng.standard_normal((3, 128, 27, 27)), device=dev)
  dh_lower = torch.tril(dh) + torch.tril(dh, -1).transpose(-1, -2)
  check("chol_factor_jvp", linalg.chol_factor_jvp(l, dh),
        linalg.chol_factor_jvp_ref(l, dh_lower), "asymmetric tangent")

  # transposed (non-contiguous) matrices and right-hand sides
  l = linalg.chol_factor_ref(spd(rng, 127, 27, dev).float())
  dh_t = sym(rng, (3, 127, 27, 27), dev).float().transpose(-1, -2)
  dl = linalg.chol_factor_jvp_ref(l, dh_t)
  check("chol_factor_jvp", linalg.chol_factor_jvp(l, dh_t), dl,
        "transposed tangents")
  x_t = torch.as_tensor(rng.standard_normal((127, 3, 27)),
                        device=dev).float().transpose(1, 2)
  db_t = torch.as_tensor(rng.standard_normal((3, 127, 3, 27)),
                         device=dev).float().transpose(-1, -2)
  dl_t = dl.transpose(-1, -2).contiguous().transpose(-1, -2)
  check("chol_solve_jvp", linalg.chol_solve_jvp(l, dl_t, x_t, db_t),
        linalg.chol_solve_jvp_ref(l, dl, x_t, db_t), "transposed inputs")

  # the bench's chunk, 1024 lanes x 75 tangents, fp32
  b, t = BENCH_CHUNK_LANES, 75
  l = linalg.chol_factor_ref(spd(rng, b, 27, dev).float())
  dh = sym(rng, (t, b, 27, 27), dev).float()
  x = torch.as_tensor(rng.standard_normal((b, 27)), device=dev).float()
  db = torch.as_tensor(rng.standard_normal((t, b, 27)), device=dev).float()
  dl = linalg.chol_factor_jvp_ref(l, dh)
  slice_err = {
      "chol_factor_jvp": check("chol_factor_jvp", linalg.chol_factor_jvp(
          l, dh), dl, "bench chunk"),
      "chol_solve_jvp": check("chol_solve_jvp", linalg.chol_solve_jvp(
          l, dl, x, db), linalg.chol_solve_jvp_ref(l, dl, x, db),
                              "bench chunk")}

  for name in worst:
    log(f"kernel: {name}",
        f"{ncase[name]} cases (n={GRID_N} x (B, T)={JVP_GRID} x fp32/fp64: "
        "tangent-major, lane-major, stride-0 and single-tangent operands"
        + (", absent dL and db, rhs (B,n) and (B,n,3)"
           if name == "chol_solve_jvp" else
           " + clamped pivots + asymmetric tangents")
        + " + transposed inputs + the bench chunk (1024, 75)): all "
        f"bit-equal to the plain version; max rel err {worst[name]:.3e} "
        "(tol fp32 1e-4, fp64 1e-12)")
  return slice_err


def time_ms(fn, reps: int = 20) -> float:
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  fn()
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / reps


def time_kernels(linalg, dev, n: int = 27, lanes: int = 0) -> dict:
  """Phase 5: kernel (wrapper included), plain version and library call at
  (lanes, n, n) fp32 (the fleet's 4096 lanes unless ``lanes`` is given; n =
  27; phase 18 at 3 and 5), timed in turns plain,
  kernel, library, library, kernel, plain; the median of each pair.  The
  bound counts what each function must move once: both read only the
  lower triangle of their (B, n, n) input, n (n + 1) / 2 elements a
  matrix.  So the factor moves B (n (n + 1) / 2 + n^2) elements (the
  dense factor is written) and does B n^3 / 3 operations; the solve moves
  B (n (n + 1) / 2 + 2 n) elements (rhs read, x written) and does 2 B n^2
  operations."""
  rng = np.random.default_rng(1)
  lanes = lanes or FLEET
  h = spd(rng, lanes, n, dev).float()
  rhs = torch.as_tensor(rng.standard_normal((lanes, n)), device=dev).float()
  l = linalg.chol_factor_ref(h)
  b, n, size = h.shape[0], h.shape[-1], h.element_size()
  tri = b * n * (n + 1) // 2  # lower-triangle elements of a (B, n, n) stack
  out = {}
  for name, kern, plain, library, (nbytes, flops) in (
      ("chol_factor", lambda: linalg.chol_factor(h),
       lambda: linalg.chol_factor_ref(h),
       lambda: torch.linalg.cholesky_ex(h),
       ((tri + h.numel()) * size, b * n**3 / 3)),
      ("chol_solve", lambda: linalg.chol_solve(l, rhs),
       lambda: linalg.chol_solve_ref(l, rhs),
       lambda: torch.cholesky_solve(rhs[..., None], l),
       ((tri + 2 * rhs.numel()) * size, 2 * b * n * n))):
    p1, k1, y1, y2, k2, p2 = (time_ms(f) for f in (
        plain, kern, library, library, kern, plain))
    bound, bound_by = bound_ms(nbytes, flops)
    out[name] = {"ms": float(np.median([k1, k2])),
                 "plain_ms": float(np.median([p1, p2])),
                 "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": float(np.median([y1, y2]))}
  log("timing", f"({lanes}, {n}) fp32, ms kernel / plain / library / bound: "
      + ", ".join(
          f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f} / {v['library_ms']:.4f}"
          f" / {v['bound_ms']:.4f} ({v['bound_by']}; kernel at "
          f"{v['bound_ms'] / v['ms']:.1%} of it)" for k, v in out.items()))
  return out


def jvp_work(n: int, b: int, t: int, size: int) -> dict:
  """What each JVP function must move and compute for b lanes of t
  tangents each: L is read once a lane (its lower triangle), each
  tangent's dH triangle read and its dense dL written; the factor's JVP
  does 3 (n-k-1) + 2 (n-k-1) (n-k) operations a tangent at pivot k.  The
  solve's JVP reads L and x once a lane and each tangent's dL triangle and
  db, writes dx, and sweeps y = Lᵀx once a lane and four triangles a
  tangent (t, u, v, dx), n (n + 1) operations a sweep."""
  tri = n * (n + 1) // 2
  ops = sum(3 * (n - k - 1) + 2 * (n - k - 1) * (n - k) for k in range(n))
  sweep = n * (n + 1)
  return {"chol_factor_jvp": ((b * tri + b * t * (tri + n * n)) * size,
                              b * t * ops),
          "chol_solve_jvp": ((b * (tri + n) + b * t * (tri + 2 * n)) * size,
                             b * sweep + 4 * b * t * sweep)}


def constraint_model(mt, name: str, dev, dtype, integrator: str = "EULER"):
  """put_model of phase 18's model ``name`` from its snapshot."""
  return humanoid(mt, f"{name}.npz", dev, dtype, integrator)


def constraint_shapes(mt) -> tuple[set, set]:
  """Phase 18's launches: (n, B, dtype) of the primal kernels and (n, B,
  T, dtype) of the JVP kernels.  factor_m factors each size of dof block
  as one batch of (lanes x blocks of that size), the Newton Hessian and
  Euler's M + h diag(damping) are nv x nv: for each model, at the fleet
  (4096 fp32) and the kernel-vs-plain and inverse_test lanes (64 fp64);
  on the slider crank also transition_ad's 8 lanes (its JVPs at 2 nv + nu
  tangents) and transition_fd's 8 x (2 (2 nv + nu) + 1) copies."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth

  primal, jvp = set(), set()
  for name in CONSTRAINT_MODELS:
    m = constraint_model(mt, name, "cpu", torch.float64)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(FLEET, torch.float32), (64, torch.float64)]
    if name == "slider_crank":
      nz = 2 * m.nv + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def tendon_shapes(mt) -> tuple[set, set]:
  """Phase 19's launches, as ``constraint_shapes`` counts them: each
  model's nv and dof blocks at the fleet (4096 fp32) and the 64-lane fp64
  runs; on the tendon arm also transition_ad's 8 lanes (JVPs at 2 nv + na
  + nu tangents) and transition_fd's 8 x (2 (2 nv + na + nu) + 1) copies,
  and the reach iLQR's rollout (F), forward pass (F x alphas) and
  linearization (F H lanes: a forward and the dual step), at F = 64 fp32
  and F = 4 fp64."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  primal, jvp = set(), set()
  for name in TENDON_MODELS:
    m = constraint_model(mt, name, "cpu", torch.float64)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(FLEET, torch.float32), (64, torch.float64)]
    if name == "tendon_arm":
      nz = derivative.state_dim(m) + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
      for f, dt in ((REACH_F, torch.float32),
                    (REACH_CHECK_LANES, torch.float64)):
        runs += [(f, dt), (f * REACH_ALPHAS, dt), (f * REACH_H, dt)]
        jvp |= {(sz, f * REACH_H * k, nz, dt) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def convex_shapes(mt) -> tuple[set, set]:
  """Phase 20's launches, as ``constraint_shapes`` counts them: each
  model's nv and dof blocks (six-dof free bodies) at the fleet (4096
  fp32), the 64-lane fp64 runs and the 64-lane fp32 contacts; on the box
  stack also transition_ad's 8 lanes (JVPs at 2 nv tangents) and
  transition_fd's 8 x (4 nv + 1) copies."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth

  primal, jvp = set(), set()
  for name in CONVEX_MODELS:
    m = constraint_model(mt, name, "cpu", torch.float64)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(FLEET, torch.float32), (64, torch.float64),
            (64, torch.float32)]
    if name == "box_stack":
      nz = 2 * m.nv + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def contact_shapes(mt) -> tuple[set, set]:
  """Phase 22's launches, as ``constraint_shapes`` counts them: each
  elliptic model's nv and dof blocks at the fleet (4096 fp32) and the
  64-lane fp64 runs (box_stack's inverse_test among them), box_stack's
  transition_ad (8 lanes, JVPs at 2 nv tangents) and transition_fd (8 x
  (4 nv + 1) copies); sphere_budget and its unbudgeted scene at the fleet.
  The pyramidal fleets run at the same shapes."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth

  primal, jvp = set(), set()
  for name in CONTACT_MODELS + ("sphere_budget",):
    m = contact_model(mt, name, "cpu", torch.float64)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(FLEET, torch.float32)]
    if name != "sphere_budget":
      runs.append((64, torch.float64))
    if name == "box_stack":
      nz = 2 * m.nv + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def quadruped_shapes(mt) -> tuple[set, set]:
  """Phase 23's launches, as ``constraint_shapes`` counts them: each
  model's nv and dof blocks at the fleet (4096 fp32), the 64-lane fp64 runs
  (the fetch model's inverse_test among them) and the 64-lane fp32
  contacts; on the fetch model also transition_ad's 8 lanes (JVPs at 2 nv
  + na + nu tangents) and transition_fd's 8 x (2 (2 nv + na + nu) + 1)
  copies."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  primal, jvp = set(), set()
  for name in SHAPES_MODELS:
    m = contact_model(mt, name, "cpu", torch.float64, cone=None)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(FLEET, torch.float32), (64, torch.float64),
            (64, torch.float32)]
    if name == "quadruped_fetch":
      nz = derivative.state_dim(m) + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def tail_shapes(mt) -> tuple[set, set]:
  """Phase 26's launches, as ``constraint_shapes`` counts them: each model's
  nv and dof blocks at the 64-lane fp64 runs, the quadruped with its
  rangefinders and the transmission scenes also at the fleet (4096 fp32),
  the quadruped's rays at 64 lanes in fp32; on it also transition_ad's 8
  lanes (JVPs at 2 nv + na + nu tangents) and transition_fd's 8 x (2 (2 nv
  + na + nu) + 1) copies.  Phase 23's quadruped fleet is
  ``quadruped_shapes``'."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  primal, jvp = set(), set()
  for name in ("quadruped_rangefinder",) + TRANSMISSION_SCENES + TAIL_SCENES:
    m = contact_model(mt, name, "cpu", torch.float64, cone=None)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(64, torch.float64)]
    if name not in TAIL_SCENES:
      runs.append((FLEET, torch.float32))
    if name == "quadruped_rangefinder":
      nz = derivative.state_dim(m) + m.nu
      runs += [(64, torch.float32), (8, torch.float64),
               (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def balance_shapes() -> tuple[set, set]:
  """Phase 21's launches beyond phase 6's fleet (4096 fp32) and the
  4-lane fp64 runs: at n = 27 in fp64, the height sweep's inverse (2001
  lanes), the one-lane forward, inverse and transition_ad (its JVPs at 2 nv
  + nu = 75 tangents), and transition_fd's 2 x 75 + 1 copies."""
  primal = {(27, b, torch.float64) for b in (BALANCE_SWEEP, 1, 151)}
  return primal, {(27, 1, 75, torch.float64)}


def path_shapes(mt) -> dict:
  """The launches of phases 6-28 and of --bench, by kernel: (n, B, dtype)
  of chol_factor, (n, B, columns, dtype) of chol_solve, (n, B, T, dtype)
  of chol_factor_jvp and (n, B, T, columns, dtype) of chol_solve_jvp.
  Phases 6-17 and --bench at n = 27.  Primal:
  the fleet step, the fp64 steps and inverse dynamics of 64 lanes, the
  transitions of 8 lanes (a forward, the dual step's primal, the centered
  FD's 8 x 151 copies), the linearization chunk (1024 lanes; 1024 x 75 in
  its folded comparison), each MPC run's fleet, forward pass (F x 8
  alphas) and chunk (F lin_batch: its forward and its dual step's
  primal), and the torque replay (4 lanes stepped, 400 states).  JVP: 75
  tangents a lane (nx + nu of the humanoid) at every dual step's lanes,
  and one a lane in the folded comparison.  Phases 18-23's from
  ``constraint_shapes``, ``tendon_shapes``, ``convex_shapes``,
  ``balance_shapes``, ``contact_shapes``, ``quadruped_shapes``, (phase
  25) ``flex_shapes``, (phase 26) ``tail_shapes``, (phase 27)
  ``plugin_shapes`` and (phase 28) ``tools_shapes``, whose solves are of
  one column; phase 24's from ``suite_shapes``, with the dual solvers'
  nefc columns."""
  f32 = {FLEET, BENCH_CHUNK_LANES, 75 * BENCH_CHUNK_LANES}
  jvp = {(8, 75, torch.float64), (BENCH_CHUNK_LANES, 75, torch.float32),
         (75 * BENCH_CHUNK_LANES, 1, torch.float32)}
  for f, lin_batch, _ in (MPC_RUN, MPC_REF_RUN, MPC_BENCH):
    f32 |= {f, 8 * f, lin_batch * f}
    jvp.add((lin_batch * f, 75, torch.float32))
  f64 = {64, 8, 151 * 8, 4, 4 * MPC_HORIZON}
  primal = ({(27, b, torch.float32) for b in f32}
            | {(27, b, torch.float64) for b in f64})
  jvp = {(27,) + s for s in jvp}
  for more_primal, more_jvp in (
      constraint_shapes(mt), tendon_shapes(mt), convex_shapes(mt),
      balance_shapes(), contact_shapes(mt), quadruped_shapes(mt),
      flex_shapes(mt), tail_shapes(mt), plugin_shapes(mt),
      tools_shapes(mt)):
    primal |= more_primal
    jvp |= more_jvp
  shapes = {"chol_factor": primal,
            "chol_solve": {(n, b, 1, dt) for n, b, dt in primal},
            "chol_factor_jvp": jvp,
            "chol_solve_jvp": {(n, b, t, 1, dt) for n, b, t, dt in jvp}}
  for k, more in suite_shapes(mt).items():
    shapes[k] |= more
  return shapes


def shape_key(s: tuple) -> tuple:
  """Sorts launch shapes by dtype, then by their numbers."""
  return (str(s[-1]),) + s[:-1]


def check_path_kernels(mt, linalg, dev) -> dict:
  """Phase 9: all four kernels against their plain versions, bit-equal, at
  each shape of ``path_shapes`` (the solve at its columns, the JVP kernels
  in both layouts); then, at the bench's chunk (1024 lanes, 75 tangents),
  the JVP kernels (wrapper included), their plain versions and the
  one-call yardsticks torch.func.vmap over torch.func.jvp of
  torch.linalg.cholesky and of torch.cholesky_solve, timed in turns plain,
  kernel, library, library, kernel, plain (medians of the pairs).  Returns
  those numbers."""
  rng = np.random.default_rng(4)
  shapes = path_shapes(mt)
  rhs = lambda b, n, k, lead=(): torch.as_tensor(rng.standard_normal(
      lead + (b, n) + ((k,) if k > 1 else ())), device=dev)
  for n, b, dt in sorted(shapes["chol_factor"], key=shape_key) if CHECKS else ():
    h = spd(rng, b, n, dev).to(dt)
    check_kernel("chol_factor", linalg.chol_factor(h),
                 linalg.chol_factor_ref(h),
                 f"main-path shape n={n} B={b} {dt}")
  for n, b, k, dt in sorted(shapes["chol_solve"], key=shape_key) if CHECKS else ():
    l = linalg.chol_factor_ref(spd(rng, b, n, dev).to(dt))
    x = rhs(b, n, k).to(dt)
    check_kernel("chol_solve", linalg.chol_solve(l, x),
                 linalg.chol_solve_ref(l, x),
                 f"main-path shape n={n} B={b} columns={k} {dt}")
  out = {}
  bench = (27, BENCH_CHUNK_LANES, 75, torch.float32)
  columns = {}
  for n, b, t, k, dt in shapes["chol_solve_jvp"]:
    columns.setdefault((n, b, t, dt), set()).add(k)
  jvp = shapes["chol_factor_jvp"] | set(columns)
  for n, b, t, dt in sorted(jvp, key=shape_key) if CHECKS else (bench,):
    h = spd(rng, b, n, dev).to(dt)
    dh = sym(rng, (t, b, n, n), dev).to(dt)
    l = linalg.chol_factor_ref(h)
    dl = linalg.chol_factor_jvp_ref(l, dh)
    case = f"main-path shape n={n} B={b} T={t} {dt}"
    if CHECKS:
      if (n, b, t, dt) in shapes["chol_factor_jvp"]:
        for d in (dh, lane_major(dh)):
          check_kernel("chol_factor_jvp", linalg.chol_factor_jvp(l, d), dl,
                       case)
      for k in sorted(columns.get((n, b, t, dt), ())):
        x, db = rhs(b, n, k).to(dt), rhs(b, n, k, (t,)).to(dt)
        ref = linalg.chol_solve_jvp_ref(l, dl, x, db)
        for a, c in ((dl, db), (lane_major(dl), lane_major(db))):
          check_kernel("chol_solve_jvp", linalg.chol_solve_jvp(l, a, x, c),
                       ref, f"{case} columns={k}")
    if (n, b, t, dt) != bench or not TIMED:
      continue
    x = torch.as_tensor(rng.standard_normal((b, n)), device=dev).to(dt)
    db = torch.as_tensor(rng.standard_normal((t, b, n)), device=dev).to(dt)
    work = jvp_work(27, b, t, h.element_size())
    vj = lambda f, p, tg: torch.func.vmap(
        lambda *u: torch.func.jvp(f, p, u)[1])(*tg)
    for name, kern, plain, library in (
        ("chol_factor_jvp", lambda: linalg.chol_factor_jvp(l, dh),
         lambda: linalg.chol_factor_jvp_ref(l, dh),
         lambda: vj(torch.linalg.cholesky, (h,), (dh,))),
        ("chol_solve_jvp", lambda: linalg.chol_solve_jvp(l, dl, x, db),
         lambda: linalg.chol_solve_jvp_ref(l, dl, x, db),
         lambda: vj(lambda a, r: torch.cholesky_solve(r, a),
                    (l, x[..., None]), (dl, db[..., None])))):
      p1, k1, y1, y2, k2, p2 = (time_ms(f, reps=10) for f in (
          plain, kern, library, library, kern, plain))
      bound, bound_by = bound_ms(*work[name])
      out[name] = {"ms": float(np.median([k1, k2])),
                   "plain_ms": float(np.median([p1, p2])),
                   "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": float(np.median([y1, y2]))}
    log("timing: JVP kernels", f"({b} lanes, {t} tangents, 27) fp32, ms "
        "kernel / plain / vmap-of-jvp yardstick / bound: " + ", ".join(
            f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f} / "
            f"{v['library_ms']:.4f} / {v['bound_ms']:.4f} ({v['bound_by']}"
            f", {work[k][0] / 1e6:.1f} MB; kernel at "
            f"{v['bound_ms'] / v['ms']:.1%} of it)" for k, v in out.items()))
  if not CHECKS:
    return out
  fmt = lambda s: "(" + ", ".join(map(str, s[:-1])) + f") {str(s[-1])[6:]}"
  log("kernel: main-path shapes",
      "all four kernels bit-equal to their plain versions (the JVP kernels "
      "in both layouts): " + "; ".join(
          f"{k} {{{', '.join(fmt(x) for x in sorted(v, key=shape_key))}}}"
          for k, v in shapes.items()))
  return out


def fleet_data(mt, m, batch: int, seed: int, drop: float = 0.0):
  """qpos0 with 0.02 noise on the hinges, the root lowered by ``drop``, and
  0.01 control noise, from a seeded numpy generator."""
  rng = np.random.RandomState(seed)
  dq = 0.02 * rng.randn(batch, m.nq)
  dq[:, :7] = 0.0
  dq[:, 2] -= drop
  d = mt.make_data(m, batch)
  return d.replace(
      qpos=d.qpos + torch.as_tensor(dq, dtype=m.dtype, device=m.device),
      ctrl=torch.as_tensor(0.01 * rng.randn(batch, m.nu), dtype=m.dtype,
                           device=m.device))


def humanoid(mt, asset: str, dev, dtype, integrator: str = "EULER",
             invdiscrete: bool = False):
  """put_model of the snapshot ``asset`` with its integrator (and the
  INVDISCRETE flag) set in the snapshot's Mapping: how a user picks them
  where there is no mujoco."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import (
      EnableBit,
      IntegratorType,
  )

  with np.load(mt.asset_path(asset)) as z:
    snap = {k: z[k] for k in z.files}
  snap["opt_integrator"] = np.array(int(IntegratorType[integrator]))
  if invdiscrete:
    snap["opt_enableflags"] = np.array(
        int(snap["opt_enableflags"]) | int(EnableBit.INVDISCRETE))
  return mt.put_model(snap, device=dev, dtype=dtype)


def fleet_step(mt, linalg, dev, card: str) -> dict:
  """Phase 6."""
  launches = {}
  if TIMED:
    m = mt.put_model(mt.asset_path("humanoid_mjx.npz"), device=dev,
                     dtype=torch.float32)
    d = mt.step(m, fleet_data(mt, m, FLEET, seed=0))  # warm-up step
    torch.cuda.synchronize()

    linalg.chol_factor.launches = 0
    linalg.chol_solve.launches = 0
    t0 = time.perf_counter()
    for _ in range(FLEET_STEPS):
      d = mt.step(m, d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"chol_factor": linalg.chol_factor.launches,
                "chol_solve": linalg.chol_solve.launches}

    for name, count in launches.items():
      if count < 4 * FLEET_STEPS:
        raise AssertionError(f"{name} launched {count} times in the fleet run")
    finite = bool(torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all())
    if not finite:
      raise AssertionError("non-finite lanes after the fleet run")
    resets = int(d.warning.sum())
    log("slice: fleet step",
        f"humanoid_mjx B={FLEET} fp32, {FLEET_STEPS} steps in {seconds:.3f} s "
        f"= {FLEET * FLEET_STEPS / seconds:.1f} steps/s on {card}; launches "
        f"{launches}; all lanes finite; auto-resets {resets}")
    profile_steps(mt, m, d, 1e3 * seconds / FLEET_STEPS)

  if CHECKS:
    # kernels against plain versions, fp64, 64 lanes, 5 steps with contacts.
    # The Newton-100 humanoid: with the MJX budget (1 Newton iteration, 4
    # line-search rounds) a contact step is discontinuous in the last bit of
    # its inputs, so two runs that differ by the order of an atomic add would
    # not agree to 1e-9 (PERF.md, Findings).
    m64 = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                       dtype=torch.float64)
    d_k = d_p = fleet_data(mt, m64, 64, seed=1, drop=0.22)
    for _ in range(5):
      d_k = mt.step(m64, d_k)
    with plain_cholesky(linalg):
      for _ in range(5):
        d_p = mt.step(m64, d_p)
    err = max(float((d_k.qpos - d_p.qpos).abs().max()),
              float((d_k.qvel - d_p.qvel).abs().max()))
    ncon = int((d_k.contact.dist < d_k.contact.includemargin).sum())
    if not err <= 1e-9:
      raise AssertionError(f"fp64 kernel vs plain steps differ by {err:.3e}")
    log("slice: fleet step",
        f"humanoid 64 lanes fp64, 5 steps, kernels vs plain: max |dqpos|,|dqvel| "
        f"{err:.3e} (tol 1e-9); {ncon} active contacts at the end")
  return launches


def profile_steps(mt, m, d, wall_ms: float, steps: int = 3) -> None:
  """Device time by kernel over a few more fleet steps (torch.profiler),
  against the unprofiled wall time of a step."""
  def run():
    out = d
    for _ in range(steps):
      out = mt.step(m, out)
    return out

  kernels = device_events(run)
  per_step = lambda us: us / steps / 1e3
  device_ms = per_step(sum(e.device_time_total for e in kernels))
  chol = []
  for name in ("chol_factor_kernel", "chol_solve_kernel"):
    us = sum(e.device_time_total for e in kernels if name in e.key)
    count = sum(e.count for e in kernels if name in e.key)
    chol.append(f"{name} {us:.2f} us over {count} launches = "
                f"{us / max(count, 1):.2f} us/launch")
  top = sorted(kernels, key=lambda e: -e.device_time_total)[:5]
  log("profile",
      f"{steps} fleet steps: device {device_ms:.3f} ms/step over "
      f"{sum(e.count for e in kernels) / steps:.0f} launches/step = "
      f"{device_ms / wall_ms:.1%} of the unprofiled {wall_ms:.3f} ms/step; "
      + "; ".join(chol) + "; top: " + "; ".join(
          f"{e.key[:60]} {per_step(e.device_time_total):.3f} ms/step "
          f"({e.count / steps:.0f})" for e in top))


def inverse_dynamics(mt, linalg, dev) -> None:
  """Phase 7: the inverse-dynamics consistency check of the reference's
  inverse_test, on 64 lanes with random applied forces and controls."""
  m = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                   dtype=torch.float64)
  b = 64
  rng = np.random.RandomState(2)
  d = fleet_data(mt, m, b, seed=3, drop=0.22)
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=dev)
  d = d.replace(
      qpos=d.qpos + t(np.concatenate(
          [np.zeros((b, 7)), 0.06 * rng.randn(b, m.nq - 7)], axis=1)),
      qvel=t(0.1 * rng.randn(b, m.nv)),
      ctrl=t(0.2 * rng.randn(b, m.nu)),
      qfrc_applied=t(0.3 * rng.randn(b, m.nv)),
      xfrc_applied=t(0.3 * rng.randn(b, m.nbody, 6)))
  linalg.chol_factor.launches = 0
  linalg.chol_solve.launches = 0
  d = mt.compare_fwd_inv(m, mt.forward(m, d))
  launches = {"chol_factor": linalg.chol_factor.launches,
              "chol_solve": linalg.chol_solve.launches}
  if not all(launches.values()):
    raise AssertionError(f"a kernel was not launched: {launches}")
  fwdinv = d.solver_fwdinv
  if not (torch.isfinite(fwdinv).all() and bool((fwdinv <= 1e-6).all())):
    raise AssertionError(f"solver_fwdinv above 1e-6: {fwdinv.amax(0)}")
  ncon = int((d.contact.dist < d.contact.includemargin).sum())
  log("slice: inverse dynamics",
      f"humanoid B=64 fp64: max solver_fwdinv "
      f"[{float(fwdinv[:, 0].max()):.3e}, {float(fwdinv[:, 1].max()):.3e}] "
      f"(tol 1e-6); Newton iterations max {int(d.solver_niter.max())}; "
      f"{ncon} active contacts; launches {launches}")


# the shapes of every kernel launch since the counts were last read by
# main_path_shapes, by kernel
SEEN_SHAPES = {k: set() for k in KERNELS}


def reset_launches(linalg) -> None:
  for k in KERNELS:
    fn = getattr(linalg, k)
    fn.launches = 0
    SEEN_SHAPES[k].update(fn.shapes)
    fn.shapes.clear()


def read_launches(linalg) -> dict:
  return {k: getattr(linalg, k).launches for k in KERNELS}


def read_tangents(linalg) -> dict:
  """The tangent counts a lane of each JVP kernel's launches since the
  counts were reset."""
  return {k: sorted({s[2] for s in getattr(linalg, k).shapes})
          for k in KERNELS if k.endswith("_jvp")}


def main_path_shapes(linalg) -> dict:
  """Every shape at which each kernel launched since the last call (as
  ``path_shapes`` keys them)."""
  reset_launches(linalg)
  seen = {k: set(v) for k, v in SEEN_SHAPES.items()}
  for v in SEEN_SHAPES.values():
    v.clear()
  return seen


def unchecked_shapes(mt, linalg) -> list:
  """The launches since the last call at shapes phase 9 did not check."""
  checked, seen = path_shapes(mt), main_path_shapes(linalg)
  return sorted(f"{k} {s}" for k in KERNELS for s in seen[k] - checked[k])


def transition(mt, linalg, dev, asset: str,
               integrator: str = "EULER") -> None:
  """Phase 10: transition_ad on 8 lanes of the humanoid ``asset`` (fp64,
  feet on the floor) under ``integrator`` with the kernels, against the
  plain versions and against transition_fd, held to 1e-4 of max|A|.  On
  the Newton-100 humanoid the FD's solves stop at the solver's tolerance,
  so its error is about that tolerance over 2 eps; on humanoid_mjx (one
  Newton iteration) it is the FD's truncation error, which falls 100x when
  eps falls 10x (the CPU tests hold transition_ad to C's finite
  differences on both, and under RK4 and IMPLICIT)."""
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  m = humanoid(mt, asset, dev, torch.float64, integrator)
  d = fleet_data(mt, m, 8, seed=1, drop=0.22)
  rng = np.random.RandomState(4)
  d = mt.forward(m, d.replace(
      qvel=torch.as_tensor(0.1 * rng.randn(8, m.nv), device=dev)))
  reset_launches(linalg)
  t0 = time.perf_counter()
  ad = derivative.transition_ad(m, d)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = read_launches(linalg)
  if not all(launches.values()):
    raise AssertionError(f"a kernel was not launched: {launches}")
  with plain_cholesky(linalg):
    plain = derivative.transition_ad(m, d)
  fd = derivative.transition_fd(m, d, eps=1e-6, flg_centered=True)
  err_plain = max(float((ad.A - plain.A).abs().max()),
                  float((ad.B - plain.B).abs().max()))
  err_fd = max(float((ad.A - fd.A).abs().max()),
               float((ad.B - fd.B).abs().max()))
  scale = float(fd.A.abs().max())
  if not err_plain <= 1e-9:
    raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
  if not err_fd <= 1e-4 * scale:
    raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
  ncon = int((d.contact.dist < d.contact.includemargin).sum())
  log("slice: transition",
      f"{asset} {integrator} 8 lanes fp64, {ncon} active contacts: "
      "transition_ad "
      f"{seconds:.3f} s; kernels vs plain max |dA|,|dB| {err_plain:.3e} "
      f"(tol 1e-9); vs transition_fd (centered, eps 1e-6) {err_fd:.3e} "
      f"(tol 1e-4 of max|A| = {1e-4 * scale:.3e}); launches {launches}, "
      f"tangents a lane {read_tangents(linalg)}")


def device_events(fn, attempts: int = 3) -> list:
  """The device events of one run of ``fn`` under torch.profiler.  The
  phases read only the card's events, so the first run records the card's
  activity alone: recording every host operator as well cost a profile of
  3 RK4 fleet steps 31 s.  The card's machine has seen a profile of device
  work come back with no device event (CUPTI): such a run is profiled
  again, with the host's activity too, up to ``attempts`` runs in all,
  before the phase fails."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  for attempt in range(attempts):
    with profile(activities=[ProfilerActivity.CUDA] if attempt == 0 else
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if kernels:
      return kernels
  raise AssertionError("the profiler recorded no device time")


def device_profile(fn) -> tuple[float, int, dict]:
  """One run of ``fn`` under torch.profiler: device ms, device launches,
  and (µs a launch, launches) of each Cholesky kernel."""
  kernels = device_events(fn)
  per_launch = {}
  for name in KERNELS:
    hit = [e for e in kernels if f"{name}_kernel" in e.key]
    us = sum(e.device_time_total for e in hit)
    count = sum(e.count for e in hit)
    per_launch[name] = (us / max(count, 1), count)
  return (sum(e.device_time_total for e in kernels) / 1e3,
          sum(e.count for e in kernels), per_launch)


def linearization_chunk(mt, linalg, dev) -> dict:
  """Phase 11: the dual step of the bench's linearization chunk, 1024
  humanoid_mjx lanes with nx + nu = 75 tangents each (fp32), by two
  routes in one call: the folded one (each lane repeated 75 times, one
  unit tangent a copy, one torch.autograd.forward_ad step of 76,800
  lanes, the JVP kernels at one tangent a lane) and transition_ad's
  (torch.func.vmap over torch.func.jvp of one step of the 1024 lanes, the
  JVP kernels at 75 tangents a lane).  For each: seconds (the second of
  two runs), peak memory, launches of the four kernels, and from a
  profiled third run the device time, device launches and each kernel's
  µs a launch.  The folded copies of a lane must step to the same bits
  (spread 0), and the new route's primal next state must equal step's of
  the same lanes to the bit.  Returns the new route's per-launch µs."""
  import torch.autograd.forward_ad as fwAD

  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  m = mt.put_model(mt.asset_path("humanoid_mjx.npz"), device=dev,
                   dtype=torch.float32)
  nf, nx = BENCH_CHUNK_LANES, derivative.state_dim(m)
  nz = nx + m.nu
  d = mt.forward(m, fleet_data(mt, m, nf, seed=5, drop=0.2))
  rep = derivative.repeat_lanes(d, nz)
  eye = torch.eye(nz, dtype=m.dtype, device=dev).repeat(nf, 1)

  def folded():
    with fwAD.dual_level():
      z = fwAD.make_dual(torch.zeros_like(eye), eye)
      dn = mt.step(m, derivative.apply_tangent(m, rep, z[:, :nx], z[:, nx:]))
      return (fwAD.unpack_dual(dn.qpos).primal,
              fwAD.unpack_dual(dn.qvel).primal)

  def vmapped():
    return derivative.transition_jacobian(m, d)

  routes = {"folded": folded, "vmap": vmapped}
  res = {}
  for name, fn in routes.items():
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(linalg)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    res[name] = {"s": time.perf_counter() - t0,
                 "peak": torch.cuda.max_memory_allocated() / 2**30,
                 "launches": read_launches(linalg), "out": out}
  qpos, qvel = res["folded"]["out"]
  spread = max(float((x.reshape(nf, nz, -1) - x[::nz, None]).abs().max())
               for x in (qpos, qvel))
  if spread != 0.0:
    raise AssertionError(f"tangent copies of a lane differ by {spread:.3e}")
  qpos, qvel, jac = res["vmap"]["out"]
  nxt = mt.step(m, d)
  if not (torch.equal(qpos, nxt.qpos) and torch.equal(qvel, nxt.qvel)):
    raise AssertionError("the vmap route's primal next state is not step's")
  if jac.shape != (nf, nx, nz) or not bool(torch.isfinite(jac).all()):
    raise AssertionError(f"Jacobian {tuple(jac.shape)}, or not finite")
  for name, fn in routes.items():
    res[name]["device"] = device_profile(fn)
  for name in routes:
    r = res[name]
    device_ms, device_launches, per_launch = r["device"]
    log("slice: linearization chunk",
        f"humanoid_mjx {nf} lanes x {nz} tangents fp32, {name} route"
        + (f" ({nf * nz} lane copies)" if name == "folded" else
           f" (one primal a lane)")
        + f": dual step {r['s']:.3f} s, peak {r['peak']:.2f} GiB, launches "
        f"{r['launches']}; profiled: device {device_ms:.3f} ms over "
        f"{device_launches} launches; per launch " + ", ".join(
            f"{k} {us:.2f} us ({c})" for k, (us, c) in per_launch.items())
        + (f"; spread of the primal across copies {spread:.1e}"
           if name == "folded" else
           "; primal next state equal to step's to the bit"))
  return res["vmap"]["device"][2]


def mpc_config(northstar, fleet: int, lin_batch: int, n_apply: int):
  """fp32 humanoid MPC at H = 100, 2 iLQR iterations, 8 alphas, one
  replan, from qpos0 with 0.01 noise on qpos and qvel (bench.py:289-299)."""
  return northstar.NorthStarConfig(
      horizon=MPC_HORIZON, fleet=fleet, n_replan=1, ilqr_iterations=2,
      n_alpha=8, lin_batch=lin_batch, qpos_noise=0.01, qvel_noise=0.01,
      n_apply=n_apply)


def plan_costs(costs: torch.Tensor) -> str:
  """Mean (the JAX package's quality signal), median and max over finite
  lanes, and the count above 1e6: a humanoid_mjx lane whose rollouts
  diverge reaches 1e20 and more and sets the mean alone."""
  finite = costs[torch.isfinite(costs)]
  return (f"plan cost over finite lanes mean {float(finite.mean()):.6e}, "
          f"median {float(finite.median()):.6e}, max "
          f"{float(finite.max()):.6e}, {int((finite > 1e6).sum())} of "
          f"{costs.numel()} lanes above 1e6")


def mpc_fleet(mt, linalg, dev, asset: str, run: tuple,
              profile_run: bool = False) -> tuple[dict, object, object]:
  """Phase 12: the north-star fleet MPC on ``asset`` with ``run`` = (F,
  lin_batch, n_apply) through northstar.measure_solves_per_sec: one timed
  run, in a process whose kernels are built and warm (its cold run, which
  costs the same in PyTorch: 155.5 s against the warm 162.9 s on an H100,
  is cut for time); --bench (``profile_run``) times a cold run, then the
  warm run, then one more solve of the fleet by iLQR stage
  (profile_mpc).  Returns the launch counts of the measured runs, the
  result and the config."""
  from mujoco_inversedynamicstest_tpu_torch.opt import northstar

  m = mt.put_model(mt.asset_path(asset), device=dev, dtype=torch.float32)
  fleet, lin_batch, n_apply = run
  cfg = mpc_config(northstar, *run)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_launches(linalg)
  res = northstar.measure_solves_per_sec(m, northstar.balance_cost(m),
                                         mt.make_data(m, 1), cfg,
                                         cold_run=profile_run)
  launches = read_launches(linalg)
  tangents = read_tangents(linalg)
  peak = torch.cuda.max_memory_allocated() / 2**30
  if not all(launches.values()):
    raise AssertionError(f"a kernel was not launched: {launches}")
  if not res.finite_lane_fraction >= 0.9:
    raise AssertionError(f"finite lanes {res.finite_lane_fraction:.3f}")
  us = res.run.us
  if us.shape != (fleet, n_apply, m.nu):
    raise AssertionError(f"applied controls {tuple(us.shape)}")
  log("slice: MPC fleet",
      f"{asset} fp32 F={fleet} H={MPC_HORIZON} iterations=2 alphas=8 "
      f"lin_batch={lin_batch} ({fleet * lin_batch} lanes x 75 tangents a "
      f"linearization chunk) n_apply={n_apply}: {res.solves_per_sec:.4f} "
      f"solves/s ({res.wall_time_s:.3f} s timed run); cold run "
      f"{res.compile_time_s:.3f} s; finite lanes "
      f"{res.finite_lane_fraction:.4f}; mean iterations "
      f"{res.mean_iterations:.3f}; {plan_costs(res.run.plan_costs[:, 0])}; "
      f"peak {peak:.2f} GiB; launches (every run) {launches}, tangents a "
      f"lane {tangents}")
  if profile_run:
    profile_mpc(m, northstar, cfg, northstar.make_fleet(
        m, mt.make_data(m, 1), cfg), asset)
  return launches, res, cfg


ILQR_STAGES = ("rollout_open_loop", "_linearize", "_quadratize_all",
               "_backward", "_forward_pass")


def profile_mpc(m, northstar, cfg, fleet_d, asset: str):
  """One fleet solve with the seconds of each iLQR stage: for this run
  only, the stage functions of opt/ilqr.py are wrapped in timers that
  synchronize the card before and after.  The solve waits on the card at
  every loop test anyway, so the timers cost little; torch.profiler would
  keep every operator of a solve in host memory.  Returns the MPCRun."""
  ilqr = sys.modules["mujoco_inversedynamicstest_tpu_torch.opt.ilqr"]
  spent = {s: [0.0, 0] for s in ILQR_STAGES}
  saved = {s: getattr(ilqr, s) for s in ILQR_STAGES}

  def timed(name, fn):
    def run(*args):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out = fn(*args)
      torch.cuda.synchronize()
      spent[name][0] += time.perf_counter() - t0
      spent[name][1] += 1
      return out
    return run

  run = northstar.fleet_mpc_fn(m, northstar.balance_cost(m), cfg)
  for s in ILQR_STAGES:
    setattr(ilqr, s, timed(s, saved[s]))
  try:
    t0 = time.perf_counter()
    out = run(fleet_d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  finally:
    for s in ILQR_STAGES:
      setattr(ilqr, s, saved[s])
  rest = wall - sum(sec for sec, _ in spent.values())
  log("profile: MPC fleet",
      f"{asset} F={cfg.fleet} lin_batch={cfg.lin_batch}, one solve timed by "
      f"stage, {wall:.3f} s: " + "; ".join(
          f"{s.lstrip('_')} {sec:.3f} s ({sec / wall:.1%}, {calls} calls)"
          for s, (sec, calls) in spent.items())
      + f"; the rest {rest:.3f} s ({rest / wall:.1%})")
  return out


def mpc_reference(mt, linalg, dev) -> dict:
  """Phase 13: the MPC of phase 12 on the Newton-100 humanoid, whose
  rollouts from these states do not diverge (in C neither:
  tests/test_torch_opt.py), so its plan costs mean something.  One solve
  timed by iLQR stage with the kernels, then the same fleet with the plain
  versions in their place (plain_cholesky): every plan cost finite and
  below 1e5, and the two runs' plan costs and applied controls equal to
  the bit, since every kernel equals its plain version to the bit and the
  step's sums run in a fixed order.  Returns the launch counts of the
  kernels' run."""
  from mujoco_inversedynamicstest_tpu_torch.opt import northstar

  asset = "humanoid.npz"
  m = mt.put_model(mt.asset_path(asset), device=dev, dtype=torch.float32)
  cfg = mpc_config(northstar, *MPC_REF_RUN)
  fleet = northstar.make_fleet(m, mt.make_data(m, 1), cfg)
  reset_launches(linalg)
  # the timed process profiles the solve by stage; the checks process
  # solves the same fleet without timers, and again with the plain versions
  if TIMED:
    run_k = profile_mpc(m, northstar, cfg, fleet, asset)
  else:
    run_k = northstar.fleet_mpc_fn(m, northstar.balance_cost(m), cfg)(fleet)
  launches = read_launches(linalg)
  costs = run_k.plan_costs[:, 0]
  if not all(launches.values()):
    raise AssertionError(f"a kernel was not launched: {launches}")
  if not (bool(torch.isfinite(costs).all()) and bool((costs < 1e5).all())):
    raise AssertionError(f"plan costs {costs.tolist()}")
  same = "not compared with the plain versions here"
  if CHECKS:
    with plain_cholesky(linalg):
      run_p = northstar.fleet_mpc_fn(m, northstar.balance_cost(m), cfg)(
          fleet)
    plain = run_p.plan_costs[:, 0]
    if not (torch.equal(costs, plain) and torch.equal(run_k.us, run_p.us)):
      raise AssertionError(
          f"kernels vs plain: plan costs differ by "
          f"{float((costs - plain).abs().max()):.3e}, controls by "
          f"{float((run_k.us - run_p.us).abs().max()):.3e}")
    same = "equal to the bit with the plain versions"
  log("slice: MPC on the Newton-100 humanoid",
      f"{asset} fp32 F={cfg.fleet} H={MPC_HORIZON} iterations=2 alphas=8 "
      f"lin_batch={cfg.lin_batch} ({cfg.fleet * cfg.lin_batch} lanes x 75 "
      f"tangents a linearization chunk): {plan_costs(costs)}; mean iterations "
      f"{float(run_k.niters.double().mean()):.3f}; plan costs and applied "
      f"controls {same}; launches {launches}")
  return launches


def mpc_torques(mt, linalg, dev, res, cfg, lanes: int = 4) -> None:
  """Phase 14: the fork's inverse_test check along MPC trajectories: the
  executed controls of ``lanes`` lanes replayed from the same initial
  states in fp64 on the Newton-100 humanoid; forward + compare_fwd_inv at
  every visited state, solver_fwdinv <= 1e-6."""
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative, northstar

  m = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                   dtype=torch.float64)
  d = derivative.select_lanes(
      northstar.make_fleet(m, mt.make_data(m, 1), cfg), slice(0, lanes))
  us = res.run.us[:lanes].to(torch.float64)
  visited = []
  for t in range(us.shape[1]):
    d = d.replace(ctrl=us[:, t])
    visited.append(d)
    d = mt.step(m, d)
  states = derivative.cat_lanes(visited)
  fwdinv = mt.compare_fwd_inv(m, mt.forward(m, states)).solver_fwdinv
  if not (bool(torch.isfinite(fwdinv).all())
          and bool((fwdinv <= 1e-6).all())):
    raise AssertionError(f"solver_fwdinv above 1e-6: {fwdinv.amax(0)}")
  log("slice: MPC torque consistency",
      f"humanoid fp64, {lanes} lanes x {us.shape[1]} executed controls "
      f"replayed: max solver_fwdinv [{float(fwdinv[:, 0].max()):.3e}, "
      f"{float(fwdinv[:, 1].max()):.3e}] over {fwdinv.shape[0]} visited "
      f"states (tol 1e-6); final root height min "
      f"{float(d.qpos[:, 2].min()):.3f}")


def integrators_fleet(mt, linalg, dev, card: str) -> dict:
  """Phase 15: phase 6's fleet stepped INTEGRATOR_STEPS times under each
  integrator (after one warm-up step), with 3 profiled RK4 steps; then each
  new integrator's fp64 steps with the kernels against the plain versions.
  Returns the primal kernels' launches summed over the integrators'
  timed runs."""
  t_phase = time.perf_counter()
  total = {"chol_factor": 0, "chol_solve": 0}
  if TIMED:
    for name in INTEGRATORS:
      m = humanoid(mt, "humanoid_mjx.npz", dev, torch.float32, name)
      d = mt.step(m, fleet_data(mt, m, FLEET, seed=0))  # warm-up step
      torch.cuda.synchronize()
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, d, INTEGRATOR_STEPS)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      for k in total:
        if not launches[k]:
          raise AssertionError(f"{k} was not launched under {name}")
        total[k] += launches[k]
      if not bool(torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()):
        raise AssertionError(f"non-finite lanes after the {name} fleet run")
      log("slice: integrators fleet",
          f"humanoid_mjx B={FLEET} fp32 {name}: {INTEGRATOR_STEPS} steps in "
          f"{seconds:.3f} s = {FLEET * INTEGRATOR_STEPS / seconds:.1f} steps/s "
          f"on {card}; launches a step " + ", ".join(
              f"{k} {v / INTEGRATOR_STEPS:g}" for k, v in launches.items())
          + f"; all lanes finite; auto-resets {int(d.warning.sum())}")
      if name == "RK4":
        profile_steps(mt, m, d, 1e3 * seconds / INTEGRATOR_STEPS)

  if CHECKS:
    # kernels against plain versions, fp64, 64 Newton-100 lanes on the floor
    for name in INTEGRATORS[1:]:
      m64 = humanoid(mt, "humanoid.npz", dev, torch.float64, name)
      d_k = d_p = fleet_data(mt, m64, 64, seed=1, drop=0.22)
      d_k = mt.step_n(m64, d_k, 5)
      with plain_cholesky(linalg):
        d_p = mt.step_n(m64, d_p, 5)
      err = max(float((d_k.qpos - d_p.qpos).abs().max()),
                float((d_k.qvel - d_p.qvel).abs().max()))
      if not err <= 1e-9:
        raise AssertionError(f"{name} fp64 kernel vs plain steps differ by "
                             f"{err:.3e}")
      ncon = int((d_k.contact.dist < d_k.contact.includemargin).sum())
      log("slice: integrators fleet",
          f"humanoid {name} {d_k.batch} lanes fp64, 5 steps, kernels vs plain: "
          "max "
          f"|dqpos|,|dqvel| {err:.3e} (tol 1e-9); {ncon} active contacts at "
          "the end")
  if TIMED:
    time_implicit_solve(linalg, dev)
  log("slice: integrators fleet",
      f"phase 15 in {time.perf_counter() - t_phase:.1f} s")
  return total


def time_implicit_solve(linalg, dev) -> None:
  """IMPLICIT's dense LU solve (torch.linalg.solve, a library call: the
  JAX package's jnp.linalg.solve is outside any Pallas kernel) against
  IMPLICITFAST's factor and solve by the kernels, at (4096, 27) fp32, in
  turns LU, kernels, kernels, LU (medians of the pairs); beside the LU
  solve's bound: the (B, n, n) systems and right-hand sides read once and
  the solutions written once, or B (2 n^3 / 3 + 2 n^2) operations."""
  rng = np.random.default_rng(6)
  h = spd(rng, FLEET, 27, dev).float()
  rhs = torch.as_tensor(rng.standard_normal((FLEET, 27)), device=dev).float()
  lu = lambda: torch.linalg.solve(h, rhs)
  chol = lambda: linalg.chol_solve(linalg.chol_factor(h), rhs)
  lu1, ch1, ch2, lu2 = (time_ms(f) for f in (lu, chol, chol, lu))
  n = h.shape[-1]
  bound, bound_by = bound_ms((h.numel() + 2 * rhs.numel()) * h.element_size(),
                             FLEET * (2 * n**3 / 3 + 2 * n * n))
  log("timing: implicit solve",
      f"({FLEET}, 27) fp32, ms: torch.linalg.solve (IMPLICIT) "
      f"{float(np.median([lu1, lu2])):.4f} (bound {bound:.5f}, {bound_by}); "
      f"chol_factor + chol_solve kernels (IMPLICITFAST) "
      f"{float(np.median([ch1, ch2])):.4f}")


def fwd_inv_step(mt, m, d):
  """One step of the fork's inverse_test under RK4 (or EULER, where the
  model's integrator is): forward and compare_fwd_inv of ``d``, and the
  step from that same forward.  ``mt.step`` would run that forward again
  on the same state (its lane reset leaves finite lanes as they are), so
  the step's bits are ``mt.step``'s; a non-finite lane fails the check
  either way.  Returns (the forward with solver_fwdinv, the next state)."""
  fwd = mt.forward(m, d)
  integrate = {0: mt.euler, 1: mt.rungekutta4}[m.opt.integrator]
  nxt = integrate(m, fwd.replace(qacc_warmstart=d.qacc_warmstart))
  return mt.compare_fwd_inv(m, fwd), nxt


def inverse_test(mt, linalg, dev) -> dict:
  """Phase 16: the fork's inverse_test under RK4, then the discrete
  inverse's recovery of the applied forces under IMPLICIT and
  IMPLICITFAST.  Returns the primal kernels' launches of the RK4 run."""
  from mujoco_inversedynamicstest_tpu_torch.ops import support

  t_phase = time.perf_counter()
  b = 64
  gen = torch.Generator(device=dev).manual_seed(16)

  def forces(m, d):
    """Fresh applied forces and controls at phase 7's scales."""
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                       dtype=m.dtype)
    return d.replace(qfrc_applied=0.3 * randn(d.batch, m.nv),
                     xfrc_applied=0.3 * randn(d.batch, m.nbody, 6),
                     ctrl=0.2 * randn(d.batch, m.nu))

  m = humanoid(mt, "humanoid.npz", dev, torch.float64, "RK4")
  d = fleet_data(mt, m, b, seed=3, drop=0.22)
  worst = torch.zeros(2, dtype=m.dtype, device=dev)
  ok = torch.ones((), dtype=torch.bool, device=dev)
  ncon = niter = 0
  reset_launches(linalg)
  t0 = time.perf_counter()
  for _ in range(INVERSE_TEST_STEPS):
    fwd, d = fwd_inv_step(mt, m, forces(m, d))
    ok &= (fwd.solver_fwdinv <= 1e-6).all()
    worst = torch.maximum(worst, fwd.solver_fwdinv.amax(0))
    ncon = max(ncon, int((fwd.contact.dist < fwd.contact.includemargin).sum()))
    niter = max(niter, int(fwd.solver_niter.max()))
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = {k: v for k, v in read_launches(linalg).items()
              if not k.endswith("_jvp")}
  if not all(launches.values()):
    raise AssertionError(f"a kernel was not launched: {launches}")
  if not bool(ok):
    raise AssertionError(f"solver_fwdinv above 1e-6: max {worst.tolist()}")
  log("slice: inverse_test",
      f"humanoid RK4 {b} lanes fp64, {INVERSE_TEST_STEPS} steps "
      f"({INVERSE_TEST_STEPS * m.opt.timestep:g} s of the fork's 1 s) in "
      f"{seconds:.3f} s, fresh forces and controls a "
      f"step: max solver_fwdinv [{float(worst[0]):.3e}, "
      f"{float(worst[1]):.3e}] over every lane and step (tol 1e-6); up to "
      f"{ncon} active contacts, {niter} Newton iterations; launches "
      f"{launches}")

  for name in ("IMPLICIT", "IMPLICITFAST"):
    m = humanoid(mt, "humanoid.npz", dev, torch.float64, name,
                 invdiscrete=True)
    d = fleet_data(mt, m, b, seed=4, drop=0.22)
    err = torch.zeros((), dtype=m.dtype, device=dev)
    for _ in range(RECOVERY_STEPS):
      d = forces(m, d)
      nxt = mt.step(m, d)
      inv = mt.inverse(m, d.replace(qacc=(nxt.qvel - d.qvel)
                                    / m.opt.timestep))
      applied = (inv.qfrc_applied + mt.fwd_actuation(m, inv).qfrc_actuator
                 + support.xfrc_accumulate(m, inv))
      # NaN-safe: a non-finite residual fails the check below
      err = torch.maximum(err, torch.nan_to_num(
          (inv.qfrc_inverse - applied).abs(), nan=float("inf")).max())
      d = nxt
    if not float(err) <= 1e-6:
      raise AssertionError(f"{name} discrete inverse residual {float(err)}")
    log("slice: inverse_test",
        f"humanoid {name} INVDISCRETE {b} lanes fp64, {RECOVERY_STEPS} "
        f"steps: (qvel' - qvel) / h through inverse gives back the applied "
        f"forces within {float(err):.3e} (tol 1e-6)")
  log("slice: inverse_test",
      f"phase 16 in {time.perf_counter() - t_phase:.1f} s")
  return launches


def profile_sensor_stage(mt, m, d) -> None:
  """Device ms and launches of the sensor stage's parts, each profiled
  alone after a forward of the fleet: the velocity stage (subtree_vel,
  the root site's velocities), rne_postconstraint, the touch sensors (the
  ray tests of every (lane, touch sensor, contact slot) pair) and the
  whole acceleration stage."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import SensorType
  from mujoco_inversedynamicstest_tpu_torch.ops import sensor, smooth

  d = mt.forward(m, d)
  touch = m.sensor_objid[m.sensor_type == SensorType.TOUCH]
  parts = {"sensor_vel": lambda: sensor.sensor_vel(m, d),
           "rne_postconstraint": lambda: smooth.rne_postconstraint(m, d),
           "touch": lambda: sensor._touch(m, d, touch),
           "sensor_acc": lambda: sensor.sensor_acc(m, d)}
  out = []
  for name, fn in parts.items():
    fn()
    device_ms, launches, _ = device_profile(fn)
    out.append(f"{name} {device_ms:.3f} ms / {launches} launches")
  log("profile: sensor stage", f"B={d.batch} fp32, device time and launches "
      "of each part: " + "; ".join(out))


def sensors(mt, linalg, dev, card: str) -> dict:
  """Phase 17: the fleet step with and without the sensor stage, in turns;
  the sensor stage with the kernels against the plain versions in fp64;
  the sensor Jacobians C, D by transition_ad against the plain versions
  and transition_fd.  Returns the kernels' launches of the sensor fleet's
  timed runs and of transition_ad, each read with the counts reset before
  it."""
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  total = dict.fromkeys(KERNELS, 0)
  if TIMED:
    names = ("humanoid_sensors", "humanoid")
    models, starts = {}, {}
    for name in names:
      m = mt.put_model(mt.asset_path(f"{name}.npz"), device=dev,
                       dtype=torch.float32)
      models[name] = m
      starts[name] = mt.step(m, fleet_data(mt, m, FLEET, seed=0, drop=0.22))
    torch.cuda.synchronize()
    total = dict.fromkeys(KERNELS, 0)
    rates = {name: [] for name in names}
    for name in names + names[::-1]:
      m = models[name]
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, starts[name], SENSOR_STEPS)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      rates[name].append(FLEET * SENSOR_STEPS / seconds)
      if not bool(torch.isfinite(d.qpos).all() and torch.isfinite(d.qvel).all()):
        raise AssertionError(f"non-finite lanes after the {name} fleet run")
      for k in ("chol_factor", "chol_solve"):
        if not launches[k]:
          raise AssertionError(f"{k} was not launched on {name}")
      if name == "humanoid_sensors":
        for k in KERNELS:
          total[k] += launches[k]
        if d.sensordata.shape != (FLEET, 66):
          raise AssertionError(f"sensordata {tuple(d.sensordata.shape)}")
        if not bool(torch.isfinite(d.sensordata).all()):
          raise AssertionError("non-finite sensordata")
        touching = d.sensordata[:, 48:] > 0
        if not bool(touching.any()):
          raise AssertionError("no touch sensor reads a force")
        log("slice: sensors",
            f"{name} B={FLEET} fp32: {SENSOR_STEPS} steps in {seconds:.3f} s "
            f"= {rates[name][-1]:.1f} steps/s on {card}; launches a step "
            + ", ".join(f"{k} {v / SENSOR_STEPS:g}" for k, v in
                        launches.items() if not k.endswith("_jvp"))
            + f"; sensordata finite; touch sensors reading > 0: "
            f"{int(touching.sum())} of {touching.numel()} (lanes with one: "
            f"{int(touching.any(1).sum())}); auto-resets "
            f"{int(d.warning.sum())}")
      else:
        log("slice: sensors",
            f"{name} B={FLEET} fp32: {SENSOR_STEPS} steps in {seconds:.3f} s "
            f"= {rates[name][-1]:.1f} steps/s on {card}; launches a step "
            + ", ".join(f"{k} {v / SENSOR_STEPS:g}" for k, v in
                        launches.items() if not k.endswith("_jvp")))
    profiled = {}
    for name in names:
      m, d = models[name], starts[name]
      device_ms, device_launches, _ = device_profile(lambda: mt.step_n(m, d, 2))
      profiled[name] = (device_ms / 2, device_launches / 2)
    profile_sensor_stage(mt, models["humanoid_sensors"],
                         starts["humanoid_sensors"])
    med = {name: float(np.median(r)) for name, r in rates.items()}
    stage = profiled["humanoid_sensors"][1] - profiled["humanoid"][1]
    log("slice: sensors",
        f"steps/s medians: with sensors {med['humanoid_sensors']:.1f}, without "
        f"{med['humanoid']:.1f} ({med['humanoid_sensors'] / med['humanoid']:.3f}"
        "x); 2 profiled steps: " + ", ".join(
            f"{n} device {ms:.3f} ms / {nl:.0f} launches a step"
            for n, (ms, nl) in profiled.items())
        + f"; the sensor stage {stage:.0f} launches a step")

  if CHECKS:
    # kernels against plain versions, fp64, 64 lanes, 5 steps on the floor
    m64 = mt.put_model(mt.asset_path("humanoid_sensors.npz"), device=dev,
                       dtype=torch.float64)
    d_k = d_p = fleet_data(mt, m64, 64, seed=1, drop=0.22)
    err = 0.0
    for _ in range(5):
      d_k = mt.step(m64, d_k)
      with plain_cholesky(linalg):
        d_p = mt.step(m64, d_p)
      err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)).abs().max())
                       for f in ("sensordata", "qpos", "qvel")))
    if not err <= 1e-9:
      raise AssertionError(f"fp64 sensor steps, kernels vs plain: {err:.3e}")
    log("slice: sensors",
        f"humanoid_sensors 64 lanes fp64, 5 steps, kernels vs plain: max "
        f"|dsensordata|,|dqpos|,|dqvel| {err:.3e} (tol 1e-9); max "
        f"|sensordata| {float(d_k.sensordata.abs().max()):.3e}; touch > 0 "
        f"{int((d_k.sensordata[:, 48:] > 0).sum())}")

    # C, D: 8 lanes fp64, Euler, feet on the floor
    d = fleet_data(mt, m64, 8, seed=1, drop=0.22)
    rng = np.random.RandomState(4)
    d = mt.forward(m64, d.replace(
        qvel=torch.as_tensor(0.1 * rng.randn(8, m64.nv), device=dev)))
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m64, d, flg_sensor=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    for k in KERNELS:
      total[k] += launches[k]
    if ad.C.shape != (8, 66, 54) or ad.D.shape != (8, 66, m64.nu):
      raise AssertionError(f"C {tuple(ad.C.shape)}, D {tuple(ad.D.shape)}")
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m64, d, flg_sensor=True)
    # from a zero warm start the perturbed solves iterate to their minimum;
    # from the forward's converged one they stop after one iteration within
    # the solver's tolerance, which 2 eps magnifies in the force rows
    fd = derivative.transition_fd(
        m64, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True, flg_sensor=True)
    err_plain = max(float((getattr(ad, f) - getattr(plain, f)).abs().max())
                    for f in "ABCD")
    err_fd = {f: float((getattr(ad, f) - getattr(fd, f)).abs().max())
              for f in "CD"}
    scale = {f: float(getattr(fd, f).abs().max()) for f in "CD"}
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    for f in "CD":
      if not err_fd[f] <= 1e-4 * scale[f]:
        raise AssertionError(f"{f} vs transition_fd: {err_fd[f]:.3e}")
    ncon = int((d.contact.dist < d.contact.includemargin).sum())
    log("slice: sensors",
        f"humanoid_sensors 8 lanes fp64 EULER, {ncon} active contacts: "
        f"transition_ad(flg_sensor=True) {seconds:.3f} s, C "
        f"{tuple(ad.C.shape)}, D {tuple(ad.D.shape)}; kernels vs plain max "
        f"|dA|,|dB|,|dC|,|dD| {err_plain:.3e} (tol 1e-9); vs transition_fd "
        + ", ".join(f"{f} {err_fd[f]:.3e} (tol 1e-4 of max|{f}| = "
                    f"{1e-4 * scale[f]:.3e})" for f in "CD")
        + f"; launches {launches}, tangents a lane {read_tangents(linalg)}")
  log("slice: sensors", f"phase 17 in {time.perf_counter() - t_phase:.1f} s")
  return total


def constraint_data(mt, m, batch: int, seed: int):
  """qpos0 moved by 0.1 randn in each dof's tangent direction, qvel 0.3
  randn and ctrl 0.2 randn, from a seeded numpy generator."""
  rng = np.random.RandomState(seed)
  t = lambda *shape: torch.as_tensor(rng.randn(batch, *shape), dtype=m.dtype,
                                     device=m.device)
  d = mt.make_data(m, batch)
  return d.replace(qpos=mt.integrate_pos(m, d.qpos, 0.1 * t(m.nv), 1.0),
                   qvel=0.3 * t(m.nv), ctrl=0.2 * t(m.nu))


def constraint_rows(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 18: the six constraint-row models' fleets, the primal kernels
  timed at n = 3 and 5, the fork's inverse_test on the slider crank, the
  kernels against the plain versions, and transition_ad.  Returns the
  kernels' launches of the kernel runs (fleets, inverse_test,
  transition_ad), each read with the counts reset before it, and the
  kernel timings at n = 3 and 5 for the kernels line."""
  from mujoco_inversedynamicstest_tpu_torch.ops import constraint
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  small = {}
  total = dict.fromkeys(KERNELS, 0)

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  if TIMED:
    for name in CONSTRAINT_MODELS:
      m = constraint_model(mt, name, dev, torch.float32)
      d = mt.step(m, constraint_data(mt, m, FLEET, seed=18))  # warm-up step
      torch.cuda.synchronize()
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, d, CONSTRAINT_STEPS)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      add(launches)
      for k in ("chol_factor", "chol_solve"):
        if not launches[k]:
          raise AssertionError(f"{k} was not launched on {name}")
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      if not bool(finite.all()):
        raise AssertionError(f"{name}: {int((~finite).sum())} non-finite lanes")
      lay = constraint.row_layout(m)
      log("slice: constraint rows",
          f"{name} (nv {m.nv}; rows: {lay.ne} equality, {lay.nf} friction, "
          f"{lay.nl} limit) B={FLEET} fp32: {CONSTRAINT_STEPS} steps in "
          f"{seconds:.3f} s = {FLEET * CONSTRAINT_STEPS / seconds:.1f} steps/s "
          f"on {card}; launches a step " + ", ".join(
              f"{k} {v / CONSTRAINT_STEPS:g}" for k, v in launches.items()
              if not k.endswith("_jvp"))
          + f"; finite lanes {int(finite.sum())} of {FLEET}; auto-resets "
          f"{int(d.warning.sum())}; active rows a lane "
          f"{float(d.efc_active.sum(1).float().mean()):.2f}")

    small = {}
    for n in (3, 5):
      for k, v in time_kernels(linalg, dev, n).items():
        small.setdefault(k, {"by_n": {}})["by_n"][str(n)] = v

  if CHECKS:
    # the fork's inverse_test: RK4, fresh forces and controls every step
    b = 64
    gen = torch.Generator(device=dev).manual_seed(18)
    m = constraint_model(mt, "slider_crank", dev, torch.float64, "RK4")
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                       dtype=m.dtype)
    d = constraint_data(mt, m, b, seed=19)
    worst = torch.zeros(2, dtype=m.dtype, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    reset_launches(linalg)
    t0 = time.perf_counter()
    for _ in range(CRANK_INVERSE_STEPS):
      d = d.replace(qfrc_applied=0.3 * randn(b, m.nv),
                    xfrc_applied=0.3 * randn(b, m.nbody, 6),
                    ctrl=0.2 * randn(b, m.nu))
      fwd, d = fwd_inv_step(mt, m, d)
      ok &= (fwd.solver_fwdinv <= 1e-6).all() & fwd.efc_active.all()
      worst = torch.maximum(worst, fwd.solver_fwdinv.amax(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    add(launches)
    if not launches["chol_factor"] or not launches["chol_solve"]:
      raise AssertionError(f"a kernel was not launched: {launches}")
    if not bool(ok):
      raise AssertionError("solver_fwdinv above 1e-6 or an inactive connect "
                           f"row: max {worst.tolist()}")
    log("slice: constraint rows",
        f"inverse_test slider_crank RK4 {b} lanes fp64, {CRANK_INVERSE_STEPS} "
        f"steps ({CRANK_INVERSE_STEPS * m.opt.timestep:g} s of the fork's 1 s, "
        f"cut for time) in {seconds:.3f} s, fresh forces and controls a step: "
        "max "
        f"solver_fwdinv [{float(worst[0]):.3e}, {float(worst[1]):.3e}] over "
        f"every lane and step (tol 1e-6); launches a step " + ", ".join(
            f"{k} {v / CRANK_INVERSE_STEPS:g}" for k, v in launches.items()
            if not k.endswith("_jvp")))

    # kernels against plain versions, fp64, 64 lanes, 5 steps
    errs = []
    for name in CONSTRAINT_MODELS:
      m = constraint_model(mt, name, dev, torch.float64)
      d_k = d_p = constraint_data(mt, m, 64, seed=20)
      err = 0.0
      for _ in range(5):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)).abs().max())
                         for f in ("qpos", "qvel", "efc_force")))
      if not err <= 1e-9:
        raise AssertionError(f"{name} fp64 steps, kernels vs plain: {err:.3e}")
      errs.append(f"{name} {err:.3e}")
    log("slice: constraint rows", "64 lanes fp64, 5 steps, kernels vs plain, "
        "max |dqpos|,|dqvel|,|defc_force| (tol 1e-9): " + ", ".join(errs))

    # transition_ad of 8 slider-crank lanes
    m = constraint_model(mt, "slider_crank", dev, torch.float64)
    d = mt.forward(m, constraint_data(mt, m, 8, seed=21))
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m, d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    add(launches)
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m, d)
    fd = derivative.transition_fd(
        m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True)
    err_plain = max(float((ad.A - plain.A).abs().max()),
                    float((ad.B - plain.B).abs().max()))
    err_fd = max(float((ad.A - fd.A).abs().max()),
                 float((ad.B - fd.B).abs().max()))
    scale = float(fd.A.abs().max())
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    if not err_fd <= 1e-4 * scale:
      raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
    log("slice: constraint rows",
        f"slider_crank 8 lanes fp64 EULER: transition_ad {seconds:.3f} s, A "
        f"{tuple(ad.A.shape)}; kernels vs plain max |dA|,|dB| {err_plain:.3e} "
        f"(tol 1e-9); vs transition_fd (centered, eps 1e-6) {err_fd:.3e} (tol "
        f"1e-4 of max|A| = {1e-4 * scale:.3e}); launches {launches}, tangents "
        f"a lane {read_tangents(linalg)}")
  log("slice: constraint rows",
      f"phase 18 in {time.perf_counter() - t_phase:.1f} s")
  return total, small


def tendon_data(mt, m, batch: int, seed: int):
  """qpos0 moved by 0.1 randn in each dof's tangent direction, qvel 0.3
  randn, activations uniform in [0, 0.5] and controls uniform in each
  limited actuator's ctrlrange (0.2 randn elsewhere), from a seeded numpy
  generator."""
  rng = np.random.RandomState(seed)
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
  rng_c = m.actuator_ctrlrange.cpu().numpy()
  ctrl = np.where(m.actuator_ctrllimited.astype(bool),
                  rng.uniform(rng_c[:, 0], rng_c[:, 1], (batch, m.nu)),
                  0.2 * rng.randn(batch, m.nu))
  d = mt.make_data(m, batch)
  return d.replace(
      qpos=mt.integrate_pos(m, d.qpos, t(0.1 * rng.randn(batch, m.nv)), 1.0),
      qvel=t(0.3 * rng.randn(batch, m.nv)),
      act=t(rng.uniform(0, 0.5, (batch, m.na))), ctrl=t(ctrl))


def arm_hand(qpos: torch.Tensor) -> torch.Tensor:
  """The tendon arm's hand site in its x-z plane: the closed-form planar
  kinematics of two 0.5 m links turning about -y from the origin;
  (..., 2) -> (..., 2)."""
  t1, t2 = qpos[..., 0], qpos[..., 0] + qpos[..., 1]
  return 0.5 * torch.stack([torch.cos(t1) + torch.cos(t2),
                            torch.sin(t1) + torch.sin(t2)], dim=-1)


def reach_cost(m, s, u, t, target):
  """BASELINE rung 2's cost of one sample: |hand - target|^2 + 1e-3 |u|^2
  (written like opt/northstar.py's balance_cost)."""
  del m, t
  dif = arm_hand(s.qpos) - target
  return dif @ dif + 1e-3 * u @ u


def reach_problems(mt, m, f: int, seed: int):
  """F reach problems from a seeded generator: the arm at rest at a pose
  inside its joint ranges, and a target that the hand reaches at another
  such pose; controls start at 0.1."""
  gen = torch.Generator(device="cpu").manual_seed(seed)
  pose = lambda lo, hi: lo + (hi - lo) * torch.rand((f, 2), generator=gen,
                                                    dtype=torch.float64)
  lo, hi = torch.tensor([-0.3, 0.2]), torch.tensor([0.9, 1.5])
  start = pose(lo, hi)
  target = arm_hand(pose(lo - 0.2, hi + 0.4))
  d = mt.make_data(m, f).replace(qpos=start.to(m.device, m.dtype))
  us = torch.full((f, REACH_H, m.nu), 0.1, dtype=m.dtype, device=m.device)
  return mt.forward(m, d), us, target.to(m.device, m.dtype)


def tendon_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 19: the tendon slice's three models' fleets (the tendon arm
  under each integrator), the primal kernels timed at n = 2, the fork's
  inverse_test on the tendon arm, BASELINE rung 2 (iLQR reach), the
  kernels against the plain versions, and transition_ad.  Returns the
  kernels' launches of the kernel runs, each read with the counts reset
  before it, and the kernel timings at n = 2."""
  from mujoco_inversedynamicstest_tpu_torch.ops import constraint
  from mujoco_inversedynamicstest_tpu_torch.opt import (
      ILQRConfig,
      derivative,
      ilqr,
  )

  t_phase = time.perf_counter()
  small = {}
  total = dict.fromkeys(KERNELS, 0)

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  if TIMED:
    runs = [("tendon_arm", i) for i in INTEGRATORS] + [
        ("actuated", "EULER"), ("tendon_rows", "EULER")]
    for name, integrator in runs:
      m = constraint_model(mt, name, dev, torch.float32, integrator)
      d = mt.step(m, tendon_data(mt, m, FLEET, seed=19))  # warm-up step
      torch.cuda.synchronize()
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, d, TENDON_STEPS)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      add(launches)
      for k in ("chol_factor", "chol_solve"):
        if not launches[k]:
          raise AssertionError(f"{k} was not launched on {name} {integrator}")
      finite = (torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
                & torch.isfinite(d.act).all(1))
      if not bool(finite.all()):
        raise AssertionError(f"{name} {integrator}: {int((~finite).sum())} "
                             "non-finite lanes")
      lay = constraint.row_layout(m)
      log("slice: tendons",
          f"{name} {integrator} (nv {m.nv}, na {m.na}, {m.ntendon} tendons; "
          f"rows: {lay.ne} equality, {lay.nf} friction, {lay.nl} limit) "
          f"B={FLEET} fp32: {TENDON_STEPS} steps in {seconds:.3f} s = "
          f"{FLEET * TENDON_STEPS / seconds:.1f} steps/s on {card}; launches a "
          "step " + ", ".join(f"{k} {v / TENDON_STEPS:g}"
                              for k, v in launches.items()
                              if not k.endswith("_jvp"))
          + f"; finite lanes {int(finite.sum())} of {FLEET}; auto-resets "
          f"{int(d.warning.sum())}")

    small = {k: {"by_n": {"2": v}} for k, v in time_kernels(linalg, dev,
                                                             2).items()}

  if CHECKS:
    # the fork's inverse_test on the tendon arm: RK4, fresh forces a step
    b = 64
    gen = torch.Generator(device=dev).manual_seed(19)
    m = constraint_model(mt, "tendon_arm", dev, torch.float64, "RK4")
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                       dtype=m.dtype)
    d = tendon_data(mt, m, b, seed=20)
    worst = torch.zeros(2, dtype=m.dtype, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    reset_launches(linalg)
    t0 = time.perf_counter()
    for _ in range(ARM_INVERSE_STEPS):
      d = d.replace(qfrc_applied=0.3 * randn(b, m.nv),
                    xfrc_applied=0.3 * randn(b, m.nbody, 6),
                    ctrl=torch.rand((b, m.nu), generator=gen, device=dev,
                                    dtype=m.dtype))
      fwd, d = fwd_inv_step(mt, m, d)
      ok &= (fwd.solver_fwdinv <= 1e-6).all()
      worst = torch.maximum(worst, fwd.solver_fwdinv.amax(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    add(launches)
    if not launches["chol_factor"] or not launches["chol_solve"]:
      raise AssertionError(f"a kernel was not launched: {launches}")
    if not bool(ok) or not bool(torch.isfinite(d.qpos).all()):
      raise AssertionError(f"solver_fwdinv above 1e-6: max {worst.tolist()}")
    log("slice: tendons",
        f"inverse_test tendon_arm RK4 {b} lanes fp64, {ARM_INVERSE_STEPS} "
        f"steps of {m.opt.timestep:g} s in {seconds:.3f} s, fresh forces and "
        f"controls a step: max solver_fwdinv [{float(worst[0]):.3e}, "
        f"{float(worst[1]):.3e}] over every lane and step (tol 1e-6); "
        "launches a step " + ", ".join(
            f"{k} {v / ARM_INVERSE_STEPS:g}" for k, v in launches.items()
            if not k.endswith("_jvp")))

  if TIMED:
    # BASELINE rung 2: iLQR reach on the tendon arm
    m = constraint_model(mt, "tendon_arm", dev, torch.float32)
    d0, us, target = reach_problems(mt, m, REACH_F, seed=21)
    cfg = ILQRConfig(iterations=REACH_ITERATIONS, n_alpha=REACH_ALPHAS)
    torch.cuda.synchronize()
    reset_launches(linalg)
    t0 = time.perf_counter()
    res = ilqr(m, reach_cost, d0, us, cfg, cost_args=(target,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    add(launches)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    finite = torch.isfinite(res.cost) & torch.isfinite(res.us).flatten(1).all(1)
    dist = lambda q: (arm_hand(q) - target).norm(dim=-1)
    start = float(dist(res.xs.qpos[:, 0]).median())
    end = float(dist(res.xs.qpos[:, -1]).median())
    if not bool(finite.all()) or not end < start:
      raise AssertionError(f"reach iLQR: {int((~finite).sum())} non-finite "
                           f"lanes, median distance {start:.4f} -> {end:.4f}")
    log("slice: tendons",
        f"BASELINE rung 2: iLQR reach on tendon_arm, F={REACH_F} fp32, "
        f"H={REACH_H}, {REACH_ITERATIONS} iterations, {REACH_ALPHAS} alphas: "
        f"{seconds:.3f} s = {REACH_F / seconds:.2f} solves/s on {card}; finite "
        f"lanes {int(finite.sum())} of {REACH_F}; mean iterations "
        f"{float(res.niter.float().mean()):.2f}; median hand-target distance "
        f"{start:.4f} m at the start, {end:.4f} m at the plan's end; plan cost "
        f"median {float(res.cost.median()):.4f}; launches {launches}")

  if CHECKS:
    m = constraint_model(mt, "tendon_arm", dev, torch.float64)
    d0, us, target = reach_problems(mt, m, REACH_CHECK_LANES, seed=22)
    cfg = ILQRConfig(iterations=REACH_CHECK_ITERATIONS, n_alpha=REACH_ALPHAS)
    reset_launches(linalg)
    kern = ilqr(m, reach_cost, d0, us, cfg, cost_args=(target,))
    add(read_launches(linalg))
    with plain_cholesky(linalg):
      plain = ilqr(m, reach_cost, d0, us, cfg, cost_args=(target,))
    rel = float(((kern.cost - plain.cost).abs() / plain.cost.abs()).max())
    if not rel <= 1e-9:
      raise AssertionError(f"reach iLQR kernels vs plain: {rel:.3e}")
    log("slice: tendons",
        f"reach iLQR {REACH_CHECK_LANES} lanes fp64, "
        f"{REACH_CHECK_ITERATIONS} iterations, kernels vs plain: plan costs "
        f"max relative difference {rel:.3e} (tol 1e-9)")

    # kernels against plain versions, fp64, 64 lanes, 5 steps
    errs = []
    for name in TENDON_MODELS:
      m = constraint_model(mt, name, dev, torch.float64)
      d_k = d_p = tendon_data(mt, m, 64, seed=23)
      err = 0.0
      for _ in range(5):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        fields = ["qpos", "qvel", "act"] + (
            ["efc_force"] if d_k.efc_force is not None else [])
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)).abs().max())
                         for f in fields))
      if not err <= 1e-9:
        raise AssertionError(f"{name} fp64 steps, kernels vs plain: {err:.3e}")
      errs.append(f"{name} {err:.3e}")
    log("slice: tendons", "64 lanes fp64, 5 steps, kernels vs plain, max "
        "|dqpos|,|dqvel|,|dact|,|defc_force| (tol 1e-9): " + ", ".join(errs))

    # transition_ad of 8 tendon-arm lanes
    m = constraint_model(mt, "tendon_arm", dev, torch.float64)
    d = mt.forward(m, tendon_data(mt, m, 8, seed=24))
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m, d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    add(launches)
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m, d)
    fd = derivative.transition_fd(
        m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True)
    err_plain = max(float((ad.A - plain.A).abs().max()),
                    float((ad.B - plain.B).abs().max()))
    err_a = float((ad.A - fd.A).abs().max())
    err_b = float((ad.B - fd.B).abs().max())
    scale_a, scale_b = float(fd.A.abs().max()), float(fd.B.abs().max())
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    if not (err_a <= 1e-4 * scale_a and err_b <= 1e-4 * scale_b):
      raise AssertionError(f"transition_ad vs transition_fd: A {err_a:.3e}, "
                           f"B {err_b:.3e}")
    log("slice: tendons",
        f"tendon_arm 8 lanes fp64 EULER: transition_ad {seconds:.3f} s, A "
        f"{tuple(ad.A.shape)}, B {tuple(ad.B.shape)}; kernels vs plain max "
        f"|dA|,|dB| {err_plain:.3e} (tol 1e-9); vs transition_fd (centered, "
        f"eps 1e-6) |dA| {err_a:.3e}, |dB| {err_b:.3e} (tol 1e-4 of max|A| = "
        f"{1e-4 * scale_a:.3e}, of max|B| = {1e-4 * scale_b:.3e}); launches "
        f"{launches}, tangents a lane {read_tangents(linalg)}")
  log("slice: tendons", f"phase 19 in {time.perf_counter() - t_phase:.1f} s")
  return total, small


def convex_data(mt, m, batch: int, seed: int):
  """qpos0 (the scene at rest in contact) moved by 0.005 randn in each
  dof's tangent direction, qvel 0.05 randn, from a seeded numpy
  generator."""
  rng = np.random.RandomState(seed)
  t = lambda *shape: torch.as_tensor(rng.randn(batch, *shape), dtype=m.dtype,
                                     device=m.device)
  d = mt.make_data(m, batch)
  return d.replace(qpos=mt.integrate_pos(m, d.qpos, 0.005 * t(m.nv), 1.0),
                   qvel=0.05 * t(m.nv))


def contact_sets(collision, m, d) -> tuple[torch.Tensor, torch.Tensor]:
  """Each (lane, geom pair)'s active contact depths as a set: (B, pairs,
  slots) depths sorted ascending, +inf where inactive, and (B, pairs)
  counts.  Slots of one pair are contiguous in the layout."""
  lay = collision.contact_layout(m)
  dist = torch.where(d.contact.dist < d.contact.includemargin,
                     d.contact.dist.double(), float("inf"))
  sets = []
  start = 0
  for grp in lay.groups:
    n = len(grp.geom1) * grp.nslot
    sets.append(dist[:, start:start + n].reshape(d.batch, len(grp.geom1),
                                                 grp.nslot))
    start += n
  width = max(x.shape[-1] for x in sets)
  pad = lambda x: torch.nn.functional.pad(x, (0, width - x.shape[-1]),
                                          value=float("inf"))
  out = torch.sort(torch.cat([pad(x) for x in sets], 1), dim=-1).values
  return out, torch.isfinite(out).sum(-1)


def box_inverse_test(mt, linalg, dev, m, phase: str, label: str,
                     steps: int, seed: int, exact_solves: bool = True,
                     data=None, scale: float = 0.3) -> dict:
  """The fork's inverse_test on 64 lanes of box_stack ``m`` (fp64, RK4):
  from convex_data's states (or ``data``'s, of the same signature), fresh
  qfrc_applied and xfrc_applied (``scale``
  randn, a torch.Generator seeded with ``seed``) every step, forward and
  compare_fwd_inv; both solver_fwdinv entries <= 1e-6 on every lane at
  every step.  solver_fwdinv[1] is the forward solve's own residual: a
  pyramidal solve ends on a quadratic piece's minimum, where it is round-off,
  but an elliptic one (``exact_solves=False``) may end on the Newton
  solver's improvement test with a residual of the solver's tolerance,
  and then only solves that met the gradient test are held to 1e-6 (C
  MuJoCo's own residual on such states reaches 9.0e-5:
  tests/test_torch_elliptic.py).  Returns the kernels' launches."""
  b = 64
  gen = torch.Generator(device=dev).manual_seed(seed)
  randn = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                     dtype=m.dtype)
  d = (data or convex_data)(mt, m, b, seed=seed + 2)
  worst = torch.zeros(2, dtype=m.dtype, device=dev)
  ok = torch.ones((), dtype=torch.bool, device=dev)
  active = torch.zeros((), dtype=torch.long, device=dev)
  # lane-steps whose solve ended on the improvement test, and of those the
  # ones with a residual above 1e-6, and their largest residual
  loose = torch.zeros(2, dtype=torch.long, device=dev)
  loose_worst = torch.zeros((), dtype=m.dtype, device=dev)
  reset_launches(linalg)
  t0 = time.perf_counter()
  for _ in range(steps):
    d = d.replace(qfrc_applied=scale * randn(b, m.nv),
                  xfrc_applied=scale * randn(b, m.nbody, 6))
    fwd, nxt = fwd_inv_step(mt, m, d)
    within = fwd.solver_fwdinv <= 1e-6
    if not exact_solves:
      last = (fwd.solver_niter.clamp(1, fwd.solver_stat.shape[1]) - 1).long()
      gradient = fwd.solver_stat[torch.arange(b, device=dev), last, 1]
      stopped = gradient >= m.opt.tolerance
      loose += torch.stack([stopped.sum(), (stopped & ~within[:, 1]).sum()])
      loose_worst = torch.maximum(loose_worst, torch.where(
          stopped, fwd.solver_fwdinv[:, 1], 0.0).max())
      within[:, 1] |= stopped
    ok &= within.all()
    worst = torch.maximum(worst, fwd.solver_fwdinv.amax(0))
    if fwd.contact is not None:
      active += (fwd.contact.dist < fwd.contact.includemargin).sum()
    d = nxt
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = read_launches(linalg)
  if not launches["chol_factor"] or not launches["chol_solve"]:
    raise AssertionError(f"a kernel was not launched: {launches}")
  if not bool(ok) or not bool(torch.isfinite(d.qpos).all()):
    raise AssertionError(f"solver_fwdinv above 1e-6: max {worst.tolist()}")
  stops = ("" if exact_solves else
           f"; {int(loose[0])} of {b * steps} solves ended on the improvement "
           f"test, {int(loose[1])} of them with solver_fwdinv[1] above 1e-6 "
           f"(max {float(loose_worst):.3e})")
  log(phase, f"inverse_test {label} "
      f"{'RK4' if m.opt.integrator == 1 else 'EULER'} {b} lanes fp64, {steps} steps "
      f"of {m.opt.timestep:g} s in {seconds:.3f} s, fresh forces a step: max "
      f"solver_fwdinv [{float(worst[0]):.3e}, {float(worst[1]):.3e}] over "
      f"every lane and step (tol 1e-6){stops}; active contacts a lane "
      f"{float(active) / b / steps:.2f}; launches a step "
      + ", ".join(f"{k} {v / steps:g}"
                  for k, v in launches.items() if not k.endswith("_jvp")))
  return launches


def convex_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 20: the convex slice's two models' fleets, the collision
  stage's share of two profiled steps, the kernels against the plain
  versions, the fp32 contacts against the fp64 ones, the fork's
  inverse_test on box_stack, and transition_ad.  Returns the kernels'
  launches of the kernel runs, each read with the counts reset before it,
  and the primal kernels' timings at each model's nv."""
  from mujoco_inversedynamicstest_tpu_torch.ops import collision, smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  times = {}
  total = dict.fromkeys(KERNELS, 0)

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  if TIMED:
    for name in CONVEX_MODELS:
      m = constraint_model(mt, name, dev, torch.float32)
      d = mt.step(m, convex_data(mt, m, FLEET, seed=20))  # warm-up step
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, d, CONVEX_STEPS)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      peak = torch.cuda.max_memory_allocated() / 2**30
      launches = read_launches(linalg)
      add(launches)
      for k in ("chol_factor", "chol_solve"):
        if not launches[k]:
          raise AssertionError(f"{k} was not launched on {name}")
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      if not bool(finite.all()):
        raise AssertionError(f"{name}: {int((~finite).sum())} non-finite lanes")
      active = (d.contact.dist < d.contact.includemargin).sum(1).float()
      lay = collision.contact_layout(m)
      log("slice: boxes and convex meshes",
          f"{name} (nv {m.nv}, {lay.ncon} contact slots in {len(lay.groups)} "
          f"pair groups) B={FLEET} fp32 EULER: {CONVEX_STEPS} steps in "
          f"{seconds:.3f} s = {FLEET * CONVEX_STEPS / seconds:.1f} steps/s on "
          f"{card}; launches a step " + ", ".join(
              f"{k} {v / CONVEX_STEPS:g}" for k, v in launches.items()
              if not k.endswith("_jvp"))
          + f"; finite lanes {int(finite.sum())} of {FLEET}; auto-resets "
          f"{int(d.warning.sum())}; active contacts a lane mean "
          f"{float(active.mean()):.2f}, max {int(active.max())}; peak "
          f"{peak:.3f} GiB")

      # the collision stage's share of two profiled steps
      step_ms, step_launches, per_launch = device_profile(
          lambda: mt.step_n(m, d, 2))
      pos = mt.fwd_position(m, d)
      collide = lambda: collision.collision(m, pos)
      collide()
      col_ms, col_launches, _ = device_profile(collide)
      log("profile: collision",
          f"{name} B={FLEET} fp32: a step {step_ms / 2:.3f} device ms / "
          f"{step_launches / 2:.0f} launches; collision {col_ms:.3f} ms / "
          f"{col_launches} launches = {col_ms / (step_ms / 2):.1%} of the "
          f"step's device time, {col_launches / (step_launches / 2):.1%} of "
          "its launches; in the steps " + ", ".join(
              f"{k} {us:.2f} us/launch ({count})"
              for k, (us, count) in per_launch.items() if count))

    times = {}
    for name in CONVEX_MODELS:
      m = constraint_model(mt, name, "cpu", torch.float64)
      for n in sorted({m.nv} | set(smooth._dof_blocks(m) or ())):
        if str(n) not in times.get("chol_factor", {}).get("by_n", {}):
          for k, v in time_kernels(linalg, dev, n).items():
            times.setdefault(k, {"by_n": {}})["by_n"][str(n)] = v

  if CHECKS:
    # kernels against plain versions, fp64, 64 lanes, 5 steps; then the fp32
    # contacts of the same 64 states against the fp64 ones
    errs, sets = [], []
    for name in CONVEX_MODELS:
      m = constraint_model(mt, name, dev, torch.float64)
      d0 = convex_data(mt, m, 64, seed=21)
      d_k = d_p = d0
      err = 0.0
      for _ in range(5):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)).abs().max())
                         for f in ("qpos", "qvel", "efc_force")))
      if not err <= 1e-9:
        raise AssertionError(f"{name} fp64 steps, kernels vs plain: {err:.3e}")
      errs.append(f"{name} {err:.3e}")

      m32 = constraint_model(mt, name, dev, torch.float32)
      reset_launches(linalg)
      for d64 in (d0, d_k):
        c64 = mt.fwd_position(m, d64)
        c32 = mt.fwd_position(m32, mt.make_data(m32, 64).replace(
            qpos=d64.qpos.float(), qvel=d64.qvel.float()))
        s64, n64 = contact_sets(collision, m, c64)
        s32, n32 = contact_sets(collision, m32, c32)
        if not torch.equal(n64, n32):
          raise AssertionError(f"{name}: fp32 and fp64 active contacts differ "
                               f"on {int((n64 != n32).sum())} (lane, pair)s")
        both = torch.isfinite(s64)
        derr = float((s64 - s32)[both].abs().max())
        if not derr <= 1e-4:
          raise AssertionError(f"{name}: fp32 vs fp64 contact depth {derr:.3e}")
        sets.append(f"{name} {int(n64.sum())} active, max |ddist| {derr:.3e}")
      add(read_launches(linalg))
    log("slice: boxes and convex meshes",
        "64 lanes fp64, 5 steps, kernels vs plain, max |dqpos|,|dqvel|,"
        "|defc_force| (tol 1e-9): " + ", ".join(errs) + "; the fp32 contacts "
        "of the first and last of those states against the fp64 ones, each "
        "(lane, geom pair)'s set: the same active contacts, depths (tol "
        "1e-4): " + ", ".join(sets))

    # the fork's inverse_test on box_stack: RK4, fresh forces every step
    m = constraint_model(mt, "box_stack", dev, torch.float64, "RK4")
    add(box_inverse_test(mt, linalg, dev, m, "slice: boxes and convex meshes",
                         "box_stack", BOX_INVERSE_STEPS, seed=20))

    # transition_ad of 8 box-stack lanes at rest in contact
    m = constraint_model(mt, "box_stack", dev, torch.float64)
    d = mt.forward(m, convex_data(mt, m, 8, seed=23))
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m, d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    add(launches)
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m, d)
    fd = derivative.transition_fd(
        m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True)
    err_plain = float((ad.A - plain.A).abs().max())
    err_fd = float((ad.A - fd.A).abs().max())
    scale = float(fd.A.abs().max())
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    if not err_fd <= 1e-4 * scale:
      raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
    ncon = int((d.contact.dist < d.contact.includemargin).sum())
    log("slice: boxes and convex meshes",
        f"box_stack 8 lanes fp64 EULER, {ncon} active contacts: transition_ad "
        f"{seconds:.3f} s, A {tuple(ad.A.shape)}; kernels vs plain max |dA| "
        f"{err_plain:.3e} (tol 1e-9); vs transition_fd (centered, eps 1e-6) "
        f"{err_fd:.3e} (tol 1e-4 of max|A| = {1e-4 * scale:.3e}); launches "
        f"{launches}, tangents a lane {read_tangents(linalg)}")
  log("slice: boxes and convex meshes",
      f"phase 20 in {time.perf_counter() - t_phase:.1f} s")
  return total, times


def balance_slice(mt, linalg, dev, card: str) -> dict:
  """Phase 21: BASELINE rung 3 on the card, the recipe of
  scripts/balance.py (python/LQR.ipynb's, on the Newton-100 humanoid): the
  pose, ctrl0, A and B by transition_ad (against transition_fd), the cost,
  the gain by lqr_gain in fp64; the fleet (BALANCE_FLEET fp32 lanes, the first half
  closed loop, the second open loop) through opt.rollout with the policy
  in ctrl_fn; then C's fp64 runs of the committed reference against the
  card's from the same inputs, and the kernels against the plain versions
  on that closed loop.  Returns the kernels' launches of the main path,
  transition_ad's and the fleet's, each read with the counts reset before
  it."""
  import scipy.linalg

  sys.path.insert(0, os.path.join(REPO, "scripts"))
  import balance
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative
  from mujoco_inversedynamicstest_tpu_torch.models.types import StateFlag

  t_phase = time.perf_counter()
  m64 = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                     dtype=torch.float64)
  reset_launches(linalg)
  t0 = time.perf_counter()
  pose = balance.balance_pose(m64)
  ctrl0 = balance.balance_control(m64, pose.qpos)
  torch.cuda.synchronize()
  pose_s = time.perf_counter() - t0
  log("slice: balance LQR",
      "pose (fp64 on the card): " + ", ".join(
          f"{k} {v:.6f}" for k, v in pose.angles.items())
      + f" rad; CoM - left foot CoM horizontal {pose.offset:.3e} m; root "
      f"lowered to the floor, then {pose.height_offset * 1e3:+.3f} mm by "
      f"the {BALANCE_SWEEP}-point inverse sweep (|qfrc_inverse[2]| "
      f"{pose.root_force:.4f} N); ctrl0 in [{float(ctrl0.min()):.4f}, "
      f"{float(ctrl0.max()):.4f}]; {pose_s:.2f} s; launches "
      f"{read_launches(linalg)}")

  d = mt.forward(m64, mt.make_data(m64, 1).replace(
      qpos=pose.qpos[None], ctrl=ctrl0[None]))
  reset_launches(linalg)
  t0 = time.perf_counter()
  tr = derivative.transition_ad(m64, d)
  torch.cuda.synchronize()
  ad_s = time.perf_counter() - t0
  ad_launches = read_launches(linalg)
  fd = derivative.transition_fd(
      m64, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
      eps=1e-6, flg_centered=True)
  scale = float(fd.A.abs().max())
  err_fd = max(float((tr.A - fd.A).abs().max()),
               float((tr.B - fd.B).abs().max()))
  if not err_fd <= 1e-4 * scale:
    raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
  a, b = tr.A[0], tr.B[0]
  q, r = balance.balance_cost(m64, pose.qpos)
  n_iter = balance.LQR_ITERATIONS
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  gain, p = mt.opt.lqr_gain(a, b, q, r, iterations=n_iter)
  torch.cuda.synchronize()
  lqr_s = time.perf_counter() - t0
  _, p_prev = mt.opt.lqr_gain(a, b, q, r, iterations=n_iter - 1)
  half, _ = mt.opt.lqr_gain(a, b, q, r, iterations=n_iter // 2)
  p_change = float(torch.linalg.norm(p - p_prev) / torch.linalg.norm(p))
  k_change = float(torch.linalg.norm(gain - half) / torch.linalg.norm(gain))
  host = [x.cpu().numpy() for x in (a, b, q, r)]
  at_one = int(np.sum(np.abs(np.linalg.eigvals(host[0]) - 1) < 1e-6))
  try:
    p_dare = scipy.linalg.solve_discrete_are(*host)
    dare = (f"|P - P_dare| / |P_dare| "
            f"{np.linalg.norm(p.cpu().numpy() - p_dare) / np.linalg.norm(p_dare):.3e}")
  except (ValueError, np.linalg.LinAlgError) as e:
    dare = f"scipy's DARE has no finite solution ({e})"
  closed = np.sort(np.abs(np.linalg.eigvals(
      host[0] - host[1] @ gain.cpu().numpy())))[::-1]
  log("slice: balance LQR",
      f"transition_ad A {tuple(a.shape)} B {tuple(b.shape)} in {ad_s:.3f} s "
      f"(launches {ad_launches}); vs transition_fd (centered, eps 1e-6) "
      f"{err_fd:.3e} (tol 1e-4 of max|A| = {1e-4 * scale:.3e}); lqr_gain "
      f"N = {n_iter} fp64 on the card in {lqr_s:.3f} s: |P_N - P_N-1| / "
      f"|P_N| {p_change:.3e}, |K_N - K_N/2| / |K_N| {k_change:.3e}; A has "
      f"{at_one} eigenvalues within 1e-6 of 1; {dare}; closed loop |eig| "
      f"{closed[:4].round(6).tolist()}")
  if not k_change <= 1e-8:
    raise AssertionError(f"the gain has not converged: {k_change:.3e}")

  # the fleet: half closed loop, half open loop (K = 0), fp32
  m32 = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                     dtype=torch.float32)
  gen = torch.Generator(device=dev).manual_seed(BALANCE_SEED)
  lanes, half_lanes = BALANCE_FLEET, BALANCE_FLEET // 2
  pose32 = pose.qpos.float()
  init = balance.fleet_states(m32, pose32, gen, lanes)
  noise = balance.smoothed_noise(m32, gen, BALANCE_STEPS, lanes)
  gains = torch.cat([gain.float().expand(half_lanes, *gain.shape),
                     torch.zeros((lanes - half_lanes,) + gain.shape,
                                 device=dev)])
  policy = balance.lqr_policy(m32, pose32, ctrl0.float(), gains, noise)
  mt.step(m32, mt.set_state(m32, mt.make_data(m32, lanes), init),
          ctrl_fn=policy)  # warm-up step
  torch.cuda.synchronize()
  reset_launches(linalg)
  t0 = time.perf_counter()
  out = mt.opt.rollout(m32, init, nstep=BALANCE_STEPS, ctrl_fn=policy)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = read_launches(linalg)
  for k in ("chol_factor", "chol_solve"):
    if launches[k] < BALANCE_STEPS:
      raise AssertionError(f"{k} launched {launches[k]} times in the fleet")
  total = {k: launches[k] + ad_launches[k] for k in KERNELS}
  if not all(total.values()):
    raise AssertionError(f"a kernel was not launched: {total}")
  finite = torch.isfinite(out.state).all(-1).all(-1)
  ok, worst = balance.balanced(m32, out.state[..., 1:1 + m32.nq], pose32)
  share_k = float(ok[:half_lanes].float().mean())
  share_0 = float(ok[half_lanes:].float().mean())
  # a lane that diverged was reset inside the step and reads as finite
  resets_k = int(out.warning[:half_lanes].sum())
  resets_0 = int(out.warning[half_lanes:].sum())
  log("slice: balance LQR",
      f"fleet B={lanes} fp32 EULER, {BALANCE_STEPS} steps "
      f"({BALANCE_STEPS * m32.opt.timestep:g} s; the notebook's 5 s cut for "
      f"time) through opt.rollout with the policy in ctrl_fn: {seconds:.3f} "
      f"s = {lanes * BALANCE_STEPS / seconds:.1f} steps/s on {card}; "
      f"balanced at every step (torso >= {balance.MIN_HEIGHT:g} of the "
      f"pose's height, CoM - foot <= {balance.MAX_OFFSET:g} m): closed loop "
      f"{share_k:.4f}, open loop (K = 0) {share_0:.4f}; max CoM - foot "
      f"median closed {float(worst[:half_lanes].median()):.4f} m, open "
      f"{float(worst[half_lanes:].median()):.4f} m; finite lanes "
      f"{int(finite.sum())} of {lanes}; auto-resets closed loop "
      f"{resets_k}, open loop {resets_0}; launches {launches}")
  if not bool(finite.all()):
    raise AssertionError(f"{int((~finite).sum())} non-finite lanes")
  if resets_k:
    raise AssertionError(f"{resets_k} auto-resets in the closed loop")
  if not share_k >= 0.9:
    raise AssertionError(f"closed-loop balanced share {share_k:.4f} < 0.9")
  # the controller must make the difference: without K the lanes fall
  if not share_0 <= 0.5:
    raise AssertionError(f"open-loop balanced share {share_0:.4f} > 0.5")

  # against C: the committed runs of scripts/balance_c_reference.py
  with np.load(mt.asset_path(BALANCE_REFERENCE)) as z:
    ref = {k: torch.as_tensor(z[k], device=dev) for k in z.files}
  rel = lambda x, y: float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
  inputs_gap = (f"the card's pose, ctrl0, K against the reference's (CPU): "
                f"max |dqpos| {float((pose.qpos - ref['qpos']).abs().max()):.3e}, "
                f"|dctrl0| {float((ctrl0 - ref['ctrl0']).abs().max()):.3e}, "
                f"|dK| / |K| {rel(gain, ref['gain']):.3e}")
  ref_policy = balance.lqr_policy(m64, ref["qpos"], ref["ctrl0"], ref["gain"],
                                  ref["noise"])

  def closed_loop():
    d = mt.set_state(m64, mt.make_data(m64, BALANCE_C_LANES), ref["init"])
    states = []
    for _ in range(ref["closed_states"].shape[1]):
      d = mt.step(m64, d, ctrl_fn=ref_policy)
      states.append(mt.get_state(m64, d, StateFlag.INTEGRATION))
    return torch.stack(states, 1)

  got = closed_loop()
  with plain_cholesky(linalg):
    plain = closed_loop()
  err_plain = float((got - plain).abs().max())
  want = ref["closed_states"]
  nq, nv = m64.nq, m64.nv
  # INTEGRATION: time, qpos, qvel, warm start, ctrl, ...
  segs = {"qpos": slice(1, 1 + nq), "qvel": slice(1 + nq, 1 + nq + nv),
          "ctrl": slice(1 + nq + 2 * nv, 1 + nq + 2 * nv + m64.nu)}
  errs = {k: float((got[..., s] - want[..., s]).abs().max())
          for k, s in segs.items()}
  err_all = float((got - want).abs().max())
  open_got = mt.opt.rollout(m64, ref["open_init"], ref["open_control"])
  err_open = float((open_got.state - ref["open_states"]).abs().max())
  log("slice: balance LQR",
      f"{inputs_gap}; {BALANCE_C_LANES} lanes fp64, "
      f"{want.shape[1]} closed-loop steps from the reference's inputs "
      f"against C's mjcb_control: max |dqpos| {errs['qpos']:.3e}, |dqvel| "
      f"{errs['qvel']:.3e}, |dctrl| {errs['ctrl']:.3e}, whole INTEGRATION "
      f"state {err_all:.3e} (tol 1e-6); kernels vs plain on it "
      f"{err_plain:.3e} (tol 1e-9); opt.rollout against "
      f"mujoco.rollout.rollout, {ref['open_states'].shape[0]} open-loop "
      f"lanes x {ref['open_states'].shape[1]} steps: {err_open:.3e} (tol "
      "1e-6)")
  if not (err_all <= 1e-6 and err_open <= 1e-6):
    raise AssertionError(f"against C: closed {err_all:.3e}, open "
                         f"{err_open:.3e}")
  if not err_plain <= 1e-9:
    raise AssertionError(f"kernels vs plain: {err_plain:.3e}")
  log("slice: balance LQR",
      f"phase 21 in {time.perf_counter() - t_phase:.1f} s")
  return total


def contact_model(mt, name: str, dev, dtype, cone: str | None = "ELLIPTIC",
                  integrator: str = "EULER", budget: bool = True):
  """put_model of the snapshot ``name`` with its friction cone and
  integrator set in the snapshot's Mapping, as phase 15 sets the
  integrator (``cone=None`` keeps the model's); ``budget=False`` drops
  MJX's contact-budget numerics."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import (
      ConeType,
      IntegratorType,
  )

  with np.load(mt.asset_path(f"{name}.npz")) as z:
    snap = {k: z[k] for k in z.files}
  if cone is not None:
    snap["opt_cone"] = np.array(int(ConeType[cone]))
  snap["opt_integrator"] = np.array(int(IntegratorType[integrator]))
  if not budget:
    snap["max_contact_points"] = snap["max_geom_pairs"] = np.array(-1)
  return mt.put_model(snap, device=dev, dtype=dtype)


def contact_data(mt, m, name: str, batch: int, seed: int):
  """The humanoid: phase 6's fleet states with the feet on the floor and
  0.1 randn qvel; the other models: qpos0 (at rest in contact) moved by
  0.005 randn in each dof's tangent direction, and qvel 0.05 randn (the
  stacks) or 0.5 randn (elliptic_pairs, whose bodies then slide), from a
  seeded numpy generator."""
  rng = np.random.RandomState(seed)
  t = lambda *shape: torch.as_tensor(rng.randn(batch, *shape), dtype=m.dtype,
                                     device=m.device)
  if name == "humanoid":
    d = fleet_data(mt, m, batch, seed, drop=0.22)
    return d.replace(qvel=0.1 * t(m.nv))
  d = mt.make_data(m, batch)
  vel = 0.5 if name == "elliptic_pairs" else 0.05
  return d.replace(qpos=mt.integrate_pos(m, d.qpos, 0.005 * t(m.nv), 1.0),
                   qvel=vel * t(m.nv))


def middle_share(constraint, m, d) -> tuple[int, int]:
  """(active elliptic slots in the cone's middle zone, active elliptic
  slots) at the qacc of ``d``'s last forward."""
  ct = constraint.cone_tables(m)
  jar = (d.efc_J @ d.qacc[..., None])[..., 0] - d.efc_aref
  middle = constraint.cone_quantities(m, d, jar).middle
  active = (d.contact.dist < d.contact.includemargin)[:, m.const(ct.slot)]
  return int((middle & active).sum()), int(active.sum())


def timed_fleet(mt, linalg, m, d, steps: int):
  """A warm-up step, then ``steps`` steps (step_n), synchronized: the end
  state, seconds and the kernels' launches of the timed steps."""
  d = mt.step(m, d)
  torch.cuda.synchronize()
  reset_launches(linalg)
  t0 = time.perf_counter()
  d = mt.step_n(m, d, steps)
  torch.cuda.synchronize()
  return d, time.perf_counter() - t0, read_launches(linalg)


def contact_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 22: the contact models.  Elliptic cones on box_stack,
  convex_mesh, the Newton-100 humanoid and elliptic_pairs (the cone set in
  each snapshot's Mapping): each fleet (4096 fp32, CONTACT_STEPS EULER
  steps) and the
  same under the pyramidal cone, in turns; the kernels against the plain
  versions on 64 fp64 lanes x 5 steps of each; the fork's inverse_test and
  transition_ad on elliptic box_stack; then sphere_budget (MJX's contact
  budget) against the same scene without its numerics.  Returns the
  kernels' launches of these runs, each read with the counts reset before
  it, and the primal kernels' timings at the new n."""
  from mujoco_inversedynamicstest_tpu_torch.ops import collision, constraint
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  times = {}
  total = dict.fromkeys(KERNELS, 0)

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  if TIMED:
    middle_all = 0
    for i, name in enumerate(CONTACT_MODELS):
      runs = {}
      # in turns: elliptic first on even models, pyramidal first on odd ones
      for cone in (("ELLIPTIC", "PYRAMIDAL") if i % 2 == 0
                   else ("PYRAMIDAL", "ELLIPTIC")):
        m = contact_model(mt, name, dev, torch.float32, cone)
        d, seconds, launches = timed_fleet(
            mt, linalg, m, contact_data(mt, m, name, FLEET, seed=22),
            CONTACT_STEPS)
        add(launches)
        finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
        runs[cone] = dict(m=m, d=d, seconds=seconds, launches=launches,
                          finite=int(finite.sum()), resets=int(d.warning.sum()),
                          rows=constraint.row_layout(m).nefc)
        if not launches["chol_factor"] or not launches["chol_solve"]:
          raise AssertionError(f"{name} {cone}: a kernel was not launched")
        if runs[cone]["finite"] != FLEET:
          raise AssertionError(f"{name} {cone}: non-finite lanes")
      ell, pyr = runs["ELLIPTIC"], runs["PYRAMIDAL"]
      mid, act = middle_share(constraint, ell["m"], ell["d"])
      middle_all += mid
      rate = lambda r: FLEET * CONTACT_STEPS / r["seconds"]
      active = (ell["d"].contact.dist
                < ell["d"].contact.includemargin).sum(1).float()
      log("slice: contact models",
          f"{name} (nv {ell['m'].nv}) B={FLEET} fp32 EULER, {CONTACT_STEPS} "
          f"steps: elliptic {rate(ell):.1f} steps/s, pyramidal "
          f"{rate(pyr):.1f} steps/s (in turns), ratio "
          f"{rate(ell) / rate(pyr):.3f} on {card}; rows elliptic "
          f"{ell['rows']}, pyramidal {pyr['rows']}; factorizations a step "
          f"elliptic {ell['launches']['chol_factor'] / CONTACT_STEPS:g}, "
          f"pyramidal {pyr['launches']['chol_factor'] / CONTACT_STEPS:g}; "
          f"finite lanes {ell['finite']} and {pyr['finite']} of {FLEET}; "
          f"auto-resets {ell['resets']} and {pyr['resets']}; active contacts "
          f"a lane {float(active.mean()):.2f}; active elliptic slots in the "
          f"middle zone {mid} of {act} = {mid / max(act, 1):.4f}")
      if ell["resets"]:
        raise AssertionError(f"{name}: {ell['resets']} auto-resets under the "
                             "elliptic cone")
    if not middle_all:
      raise AssertionError("no elliptic slot in the middle zone: the cone's "
                           "force never ran")

  if CHECKS:
    # kernels against plain versions, fp64, 64 lanes, 5 steps of each
    errs = []
    reset_launches(linalg)
    for name in CONTACT_MODELS:
      m = contact_model(mt, name, dev, torch.float64)
      d_k = d_p = contact_data(mt, m, name, 64, seed=23)
      err = 0.0
      for _ in range(5):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)).abs().max())
                         for f in ("qpos", "qvel", "efc_force")))
      if not err <= 1e-9:
        raise AssertionError(f"{name} fp64 steps, kernels vs plain: {err:.3e}")
      errs.append(f"{name} {err:.3e}")
    add(read_launches(linalg))
    log("slice: contact models",
        "elliptic, 64 lanes fp64, 5 steps, kernels vs plain, max |dqpos|,"
        "|dqvel|,|defc_force| (tol 1e-9): " + ", ".join(errs))

    # the fork's inverse_test on elliptic box_stack
    m = contact_model(mt, "box_stack", dev, torch.float64, integrator="RK4")
    add(box_inverse_test(mt, linalg, dev, m, "slice: contact models",
                         "elliptic box_stack", CONTACT_INVERSE_STEPS, seed=24,
                         exact_solves=False))

    # transition_ad of 8 elliptic box-stack lanes, sliding
    m = contact_model(mt, "box_stack", dev, torch.float64)
    d = contact_data(mt, m, "box_stack", 8, seed=25)
    d = mt.forward(m, d.replace(qvel=10 * d.qvel))
    mid, act = middle_share(constraint, m, d)
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m, d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    add(launches)
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m, d)
    fd = derivative.transition_fd(
        m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True)
    err_plain = float((ad.A - plain.A).abs().max())
    err_fd = float((ad.A - fd.A).abs().max())
    scale = float(fd.A.abs().max())
    if not mid:
      raise AssertionError("transition_ad's states have no middle-zone slot")
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    if not err_fd <= 1e-4 * scale:
      raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
    log("slice: contact models",
        f"elliptic box_stack 8 lanes fp64 EULER, sliding, {mid} of {act} "
        f"active elliptic slots in the middle zone: transition_ad "
        f"{seconds:.3f} s; kernels vs plain max |dA| {err_plain:.3e} (tol "
        f"1e-9); vs transition_fd (centered, eps 1e-6) {err_fd:.3e} (tol 1e-4 "
        f"of max|A| = {1e-4 * scale:.3e}); launches {launches}, tangents a "
        f"lane {read_tangents(linalg)}")

  if TIMED:
    # MJX's contact budget against the same scene without it
    out = {}
    for budget in (True, False):
      m = contact_model(mt, "sphere_budget", dev, torch.float32, cone=None,
                        budget=budget)
      d = mt.make_data(m, FLEET)
      d = d.replace(qvel=0.1 * torch.randn(
          d.qvel.shape, generator=torch.Generator(device=dev).manual_seed(26),
          device=dev))
      d, seconds, launches = timed_fleet(mt, linalg, m, d, BUDGET_STEPS)
      add(launches)
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      active = (d.contact.dist < d.contact.includemargin).sum(1).float()
      out[budget] = (FLEET * BUDGET_STEPS / seconds, int(finite.sum()))
      log("slice: contact models",
          f"sphere_budget {'with' if budget else 'without'} its numerics B="
          f"{FLEET} fp32: {collision.contact_layout(m).ncon} slots a lane, "
          f"active contacts a lane mean {float(active.mean()):.2f} max "
          f"{int(active.max())}; {BUDGET_STEPS} steps in {seconds:.3f} s = "
          f"{out[budget][0]:.1f} steps/s; finite lanes {out[budget][1]} of "
          f"{FLEET}; auto-resets {int(d.warning.sum())}; launches a step "
          + ", ".join(f"{k} {v / BUDGET_STEPS:g}" for k, v in launches.items()
                      if not k.endswith("_jvp")))
      if out[budget][1] != FLEET:
        raise AssertionError("sphere_budget: non-finite lanes")
    # the primal kernels at the new n: elliptic_pairs' nv and its dof blocks
    # other than the free bodies' 6, sphere_budget's nv
    from mujoco_inversedynamicstest_tpu_torch.ops import smooth

    times = {}
    for name in ("elliptic_pairs", "sphere_budget"):
      m = contact_model(mt, name, "cpu", torch.float64, cone=None)
      for n in sorted(({m.nv} | set(smooth._dof_blocks(m) or ())) - {6}):
        for k, v in time_kernels(linalg, dev, n).items():
          times.setdefault(k, {"by_n": {}})["by_n"][str(n)] = v
    log("slice: contact models",
        f"budget speedup {out[True][0] / out[False][0]:.3f}x; phase 22 in "
        f"{time.perf_counter() - t_phase:.1f} s")
  return total, times


def lowest_points(m, pos) -> np.ndarray:
  """(B, ngeom) the height of each geom's lowest point at ``pos``'s
  frames: a sphere's, capsule's, cylinder's, ellipsoid's and box's exact
  support along -z, a mesh's bounding sphere."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType

  z = pos.geom_xpos[..., 2]
  az = pos.geom_xmat[..., 2, :].abs()          # |z row| of each frame
  s = m.geom_size
  r, hl = s[:, 0], s[:, 1]
  t = lambda k: m.const(m.geom_type == k)
  low = torch.where(t(GeomType.SPHERE), z - r, z - m.geom_rbound)
  low = torch.where(t(GeomType.CAPSULE), z - r - hl * az[..., 2], low)
  low = torch.where(t(GeomType.CYLINDER), z - hl * az[..., 2] - r * torch.sqrt(
      torch.clamp(1 - az[..., 2] ** 2, min=0.0)), low)
  low = torch.where(t(GeomType.ELLIPSOID),
                    z - torch.sqrt(((s * az) ** 2).sum(-1)), low)
  low = torch.where(t(GeomType.BOX), z - (s * az).sum(-1), low)
  return low.cpu().numpy()


def drop_onto(mt, m, d, ground, gap: float):
  """``d`` with each free body's root moved up or down so that the lowest
  point of its geoms (``lowest_points``) lies ``gap`` above ``ground(x,
  y)`` (host numpy heights of the world's floor or terrain) under its root;
  bodies that hang from another move with it."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import JointType

  pos = mt.fwd_position(m, d)
  low = lowest_points(m, pos)
  xpos = pos.xpos.cpu().numpy()
  qpos = d.qpos.cpu().numpy().copy()
  for j in np.nonzero(m.jnt_type == JointType.FREE)[0]:
    root = int(m.body_rootid[np.nonzero(m.body_jntadr == j)[0][0]])
    geoms = np.nonzero(m.body_rootid[m.geom_bodyid] == root)[0]
    a = int(m.jnt_qposadr[j])
    x, y = xpos[:, root, 0], xpos[:, root, 1]
    qpos[:, a + 2] += ground(x, y) + gap - low[:, geoms].min(1)
  return d.replace(qpos=torch.as_tensor(qpos, dtype=m.dtype,
                                        device=m.device))


def field_height(m):
  """The top surface of height field 0 at world (x, y), the field's geom
  at its pose (turned about z by none): heights of the cell's triangle."""
  grid = m.hfield_grid[0]
  geom = int(np.nonzero(m.geom_type == 1)[0][0])
  z0 = float(m.geom_pos[geom, 2])
  ox, oy = float(m.geom_pos[geom, 0]), float(m.geom_pos[geom, 1])

  def height(x, y):
    cf = np.clip((x - ox + grid.size[0]) / grid.dx, 0, grid.ncol - 1 - 1e-9)
    rf = np.clip((y - oy + grid.size[1]) / grid.dy, 0, grid.nrow - 1 - 1e-9)
    ci, ri = np.floor(cf).astype(int), np.floor(rf).astype(int)
    fx, fy = cf - ci, rf - ri
    z = grid.vert[..., 2]
    z00, z11 = z[ri, ci], z[ri + 1, ci + 1]
    # the cell's (c, r) -> (c+1, r+1) diagonal splits it in two triangles
    upper = fx >= fy
    zc = np.where(upper, z[ri, ci + 1], z[ri + 1, ci])
    return z0 + np.where(upper, z00 + fx * (zc - z00) + fy * (z11 - zc),
                         z00 + fy * (zc - z00) + fx * (z11 - zc))

  return height


def quadruped_data(mt, m, name: str, batch: int, seed: int,
                   ball_on_torso: bool = False):
  """States the way dm_control's tasks start them, from a seeded numpy
  generator: each free body's orientation random (a normalized randn
  quaternion), the quadruped's legs at qpos0 and the body lowered onto the
  floor, its lowest point 2 mm into it (the fetch ball on the floor 0.5-2
  m away, or resting on the upright torso); terrain_objects' objects at
  their x, y with 0.05 randn, lowered onto the terrain likewise; controls
  uniform in ctrlrange, qvel 0.05 randn."""
  rng = np.random.RandomState(seed)
  d = mt.make_data(m, batch)
  qpos = d.qpos.cpu().numpy().copy()
  quat = lambda: (lambda q: q / np.linalg.norm(q, axis=1, keepdims=True))(
      rng.randn(batch, 4))
  if name == "terrain_objects":
    for a in range(0, m.nq, 7):
      qpos[:, a:a + 2] += 0.05 * rng.randn(batch, 2)
      qpos[:, a + 3:a + 7] = quat()
    ground = field_height(m)
  else:
    qpos[:, 3:7] = np.tile([1.0, 0.0, 0.0, 0.0], (batch, 1)) if (
        ball_on_torso) else quat()
    if name == "quadruped_fetch":
      # the ball: its free joint follows the quadruped's 7 + 16 hinges
      r, phi = rng.uniform(0.5, 2.0, batch), rng.uniform(0, 2 * np.pi, batch)
      qpos[:, 23:25] = np.c_[r * np.cos(phi), r * np.sin(phi)]
      qpos[:, 26:30] = quat()
    ground = lambda x, y: np.zeros_like(x)
  lo, hi = m.actuator_ctrlrange.cpu().numpy().T
  d = d.replace(
      qpos=torch.as_tensor(qpos, dtype=m.dtype, device=m.device),
      qvel=torch.as_tensor(0.05 * rng.randn(batch, m.nv), dtype=m.dtype,
                           device=m.device),
      ctrl=torch.as_tensor(rng.uniform(lo, hi, (batch, m.nu)),
                           dtype=m.dtype, device=m.device))
  d = drop_onto(mt, m, d, ground, -0.002)
  if ball_on_torso:
    # the ball (radius 0.15) 2 mm into the top of the torso (half-height
    # 0.2), at the torso's x, y
    qpos = d.qpos.clone()
    qpos[:, 23:26] = qpos[:, 0:3] + torch.as_tensor(
        [0.0, 0.0, 0.2 + 0.15 - 0.002], dtype=m.dtype, device=m.device)
    qpos[:, 26:30] = torch.as_tensor([1.0, 0, 0, 0], dtype=m.dtype,
                                     device=m.device)
    d = d.replace(qpos=qpos, qvel=torch.zeros_like(d.qvel))
  return d


def quadruped_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 23: cylinder and ellipsoid collision (the support descent) and
  height fields on dm_control's quadruped (walk and fetch) and on free
  objects over the escape task's terrain.  Each model's fleet (4096 fp32,
  SHAPES_STEPS EULER steps after a warm-up step) from states the way the
  tasks start them, the collision stage's share of two profiled steps and
  the primal kernels timed at the new n (timed); the fp32 contacts of 64
  states against the fp64 ones, each model's 5 fp64 steps of 64 lanes with
  the kernels against 5 with the plain versions, the fork's inverse_test on
  quadruped_fetch (RK4, 64 lanes fp64, FETCH_INVERSE_STEPS steps of fresh
  forces) and transition_ad of 8 fetch lanes with the ball on the torso
  against the plain versions and transition_fd (checks).  Returns the
  kernels' launches of these runs, each read with the counts reset before
  it, and the primal kernels' timings at the new n."""
  from mujoco_inversedynamicstest_tpu_torch.ops import collision, smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  phase = "slice: quadruped and terrain"
  total = dict.fromkeys(KERNELS, 0)
  times = {}

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  model = lambda name, dtype, integrator="EULER": contact_model(
      mt, name, dev, dtype, cone=None, integrator=integrator)
  data = lambda m, name, batch, seed, **kw: quadruped_data(
      mt, m, name, batch, seed, **kw)

  if TIMED:
    for name in SHAPES_MODELS:
      m = model(name, torch.float32)
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      d, seconds, launches = timed_fleet(
          mt, linalg, m, data(m, name, FLEET, seed=23), SHAPES_STEPS)
      peak = torch.cuda.max_memory_allocated() / 2**30
      add(launches)
      for k in ("chol_factor", "chol_solve"):
        if not launches[k]:
          raise AssertionError(f"{k} was not launched on {name}")
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      if not bool(finite.all()):
        raise AssertionError(f"{name}: {int((~finite).sum())} non-finite "
                             "lanes")
      active = (d.contact.dist < d.contact.includemargin).sum(1).float()
      lay = collision.contact_layout(m)
      kinds = sorted({f"{g.types[0].name.lower()}-{g.types[1].name.lower()}"
                      for g in lay.groups})
      log(phase,
          f"{name} (nv {m.nv}, {lay.ncon} contact slots in "
          f"{len(lay.groups)} pair groups: {', '.join(kinds)}) B={FLEET} "
          f"fp32 EULER: {SHAPES_STEPS} steps in {seconds:.3f} s = "
          f"{FLEET * SHAPES_STEPS / seconds:.1f} steps/s on {card}; "
          f"factorizations a step {launches['chol_factor'] / SHAPES_STEPS:g}"
          f", solves {launches['chol_solve'] / SHAPES_STEPS:g}; finite lanes "
          f"{int(finite.sum())} of {FLEET}; auto-resets "
          f"{int(d.warning.sum())}; active contact slots a lane mean "
          f"{float(active.mean()):.2f}, max {int(active.max())}; peak "
          f"{peak:.3f} GiB")
      # the collision stage's share of two profiled steps
      step_ms, step_launches, per_launch = device_profile(
          lambda: mt.step_n(m, d, 2))
      pos = mt.fwd_position(m, d)
      collide = lambda: collision.collision(m, pos)
      collide()
      col_ms, col_launches, _ = device_profile(collide)
      log("profile: collision",
          f"{name} B={FLEET} fp32: a step {step_ms / 2:.3f} device ms / "
          f"{step_launches / 2:.0f} launches; collision {col_ms:.3f} ms / "
          f"{col_launches} launches = {col_ms / (step_ms / 2):.1%} of the "
          f"step's device time, {col_launches / (step_launches / 2):.1%} of "
          "its launches; in the steps " + ", ".join(
              f"{k} {us:.2f} us/launch ({count})"
              for k, (us, count) in per_launch.items() if count))
    # the primal kernels at the new n: the quadrupeds' nv (the fetch model's
    # dof blocks are 22 and the ball's 6; terrain_objects' 36 and 6 are
    # phase 20's)
    for name in ("quadruped", "quadruped_fetch"):
      m = contact_model(mt, name, "cpu", torch.float64, cone=None)
      for n in sorted({m.nv} | set(smooth._dof_blocks(m) or ())) :
        if n in (6, 36) or str(n) in times.get("chol_factor", {}).get(
            "by_n", {}):
          continue
        for k, v in time_kernels(linalg, dev, n).items():
          times.setdefault(k, {"by_n": {}})["by_n"][str(n)] = v

  if CHECKS:
    # the fp32 contacts of 64 states against the fp64 ones; the kernels
    # against the plain versions, 64 lanes fp64, 5 steps
    errs, sets = [], []
    for name in SHAPES_MODELS:
      m = model(name, torch.float64)
      m32 = model(name, torch.float32)
      d0 = data(m, name, 64, seed=24)
      reset_launches(linalg)
      c64 = mt.fwd_position(m, d0)
      c32 = mt.fwd_position(m32, mt.make_data(m32, 64).replace(
          qpos=d0.qpos.float(), qvel=d0.qvel.float()))
      s64, n64 = contact_sets(collision, m, c64)
      s32, n32 = contact_sets(collision, m32, c32)
      # a hull on a height field: each prism's descent ends at one point of
      # a flat contact, which is not unique, and the 4 kept slots drop a
      # contact at the point of a deeper one; fp32 and fp64 may end at
      # other points and keep another count (PERF.md §7).  Their deepest
      # contact is held to the fp64 one.
      prism = torch.cat([torch.full((len(g.geom1),), bool(
          g.types[0] == 1 and g.types[1] in (6, 7)), device=dev)
                         for g in collision.contact_layout(m).groups])
      differ = (n64 != n32) & ~prism
      if bool(differ.any()):
        raise AssertionError(f"{name}: fp32 and fp64 active contacts differ "
                             f"on {int(differ.sum())} (lane, pair)s")
      both = torch.isfinite(s64) & ~prism[:, None]
      deep = prism & (n64 > 0)
      both[..., 0] |= deep & (n32 > 0)
      derr = float((s64 - s32)[both].abs().max()) if bool(both.any()) else 0.
      if not derr <= 1e-4 or not torch.equal(n64[deep] > 0, n32[deep] > 0):
        raise AssertionError(f"{name}: fp32 vs fp64 contact depth {derr:.3e}")
      sets.append(f"{name} {int(n64.sum())} active, max |ddist| {derr:.3e}"
                  + (f", hull-field pairs with another count of slots "
                     f"{int(((n64 != n32) & prism).sum())} of "
                     f"{int(deep.sum())}" if bool(prism.any()) else ""))
      d_k = d_p = d0
      err = 0.0
      for _ in range(5):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)
                                ).abs().max())
                         for f in ("qpos", "qvel", "efc_force")))
      add(read_launches(linalg))
      if not err <= 1e-9:
        raise AssertionError(f"{name} fp64 steps, kernels vs plain: "
                             f"{err:.3e}")
      errs.append(f"{name} {err:.3e}")
    log(phase,
        "the fp32 contacts of 64 states against the fp64 ones, each (lane, "
        "geom pair)'s set: the same active contacts (a hull on the height "
        "field: its deepest), depths (tol 1e-4): "
        + ", ".join(sets) + "; 64 lanes fp64, 5 steps, kernels vs plain, "
        "max |dqpos|,|dqvel|,|defc_force| (tol 1e-9): " + ", ".join(errs))

    # the fork's inverse_test on quadruped_fetch: RK4, fresh forces a step
    m = model("quadruped_fetch", torch.float64, "RK4")
    add(box_inverse_test(
        mt, linalg, dev, m, phase, "quadruped_fetch", FETCH_INVERSE_STEPS,
        seed=25, data=lambda mt, m, b, seed: data(m, "quadruped_fetch", b,
                                                  seed)))

    # transition_ad of 8 fetch lanes, upright, the ball resting on the torso
    m = model("quadruped_fetch", torch.float64)
    d = mt.forward(m, data(m, "quadruped_fetch", 8, seed=26,
                           ball_on_torso=True))
    ball = int(np.nonzero(m.geom_type == 2)[0][-1])
    torso = int(np.nonzero(m.geom_type == 4)[0][0])
    on = ((d.contact.geom1 == torso) & (d.contact.geom2 == ball)
          | (d.contact.geom1 == ball) & (d.contact.geom2 == torso))
    on &= d.contact.dist < d.contact.includemargin
    if not bool(on.any(1).all()):
      raise AssertionError("transition_ad's lanes: the ball is not on the "
                           "torso")
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m, d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    add(launches)
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m, d)
    fd = derivative.transition_fd(
        m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True)
    err_plain = max(float((ad.A - plain.A).abs().max()),
                    float((ad.B - plain.B).abs().max()))
    err_fd = float((ad.A - fd.A).abs().max())
    scale = float(fd.A.abs().max())
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    if not err_fd <= 1e-4 * scale:
      raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
    ncon = int((d.contact.dist < d.contact.includemargin).sum())
    log(phase,
        f"quadruped_fetch 8 lanes fp64 EULER, upright, the ball on the torso "
        f"(an ellipsoid-sphere descent pair), {ncon} active contacts: "
        f"transition_ad {seconds:.3f} s, A {tuple(ad.A.shape)}, B "
        f"{tuple(ad.B.shape)}; kernels vs plain max |dA|,|dB| "
        f"{err_plain:.3e} (tol 1e-9); vs transition_fd (centered, eps 1e-6) "
        f"max |dA| {err_fd:.3e} = {err_fd / scale:.3e} of max|A| "
        f"{scale:.3e} (tol 1e-4 of it); launches {launches}, tangents a "
        f"lane {read_tangents(linalg)}")
  log(phase, f"phase 23 in {time.perf_counter() - t_phase:.1f} s")
  return total, times


def suite_model(mt, name: str, dev, dtype, solver: str | None = None,
                noslip: int = 0, integrator: str | None = None):
  """put_model of the snapshot ``name`` with its solver, noslip iterations
  and integrator set in the snapshot's Mapping where given (the model's
  own otherwise), as phase 22 sets the cone."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import (
      IntegratorType,
      SolverType,
  )

  with np.load(mt.asset_path(f"{name}.npz")) as z:
    snap = {k: z[k] for k in z.files}
  if solver is not None:
    snap["opt_solver"] = np.array(int(SolverType[solver]))
  if noslip:
    snap["opt_noslip_iterations"] = np.array(noslip)
  if integrator is not None:
    snap["opt_integrator"] = np.array(int(IntegratorType[integrator]))
  return mt.put_model(snap, device=dev, dtype=dtype)


def suite_data(mt, m, name: str, batch: int, seed: int):
  """States the way the dm_control tasks start them, from a seeded numpy
  generator: swimmer15 (swimmer.py, randomize_limited_and_rotational_joints)
  each limited hinge uniform in its range and the root's rotation in
  [-pi, pi]; fish (fish.py) a random root orientation, the fins and tail
  uniform in [-0.2, 0.2]; acrobot and pendulum (swingup) their hinges
  uniform in [-pi, pi]; cartpole (swingup) the cart at 0.01 randn, the
  pole at pi + 0.01 randn, qvel 0.01 randn; the controls uniform in
  ctrlrange.  humanoid, box_stack and elliptic_pairs: phase 22's
  ``contact_data``."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import JointType

  if name not in SUITE_MODELS:
    return contact_data(mt, m, name, batch, seed)
  rng = np.random.RandomState(seed)
  d = mt.make_data(m, batch)
  qpos = d.qpos.cpu().numpy().copy()
  qvel = np.zeros((batch, m.nv))
  rng_lim = m.jnt_range.cpu().numpy()
  for j, (jt, adr) in enumerate(zip(m.jnt_type, m.jnt_qposadr)):
    if jt == JointType.FREE:
      q = rng.randn(batch, 4)
      qpos[:, adr + 3:adr + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    elif name == "fish":
      qpos[:, adr] = rng.uniform(-0.2, 0.2, batch)
    elif name == "cartpole":
      qpos[:, adr] = (np.pi if jt == JointType.HINGE else 0.0) + (
          0.01 * rng.randn(batch))
    elif m.jnt_limited[j]:
      qpos[:, adr] = rng.uniform(*rng_lim[j], batch)
    elif jt == JointType.HINGE:
      qpos[:, adr] = rng.uniform(-np.pi, np.pi, batch)
  if name == "cartpole":
    qvel = 0.01 * rng.randn(batch, m.nv)
  lo, hi = m.actuator_ctrlrange.cpu().numpy().T
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
  return d.replace(qpos=t(qpos), qvel=t(qvel),
                   ctrl=t(rng.uniform(lo, hi, (batch, m.nu))))


def suite_configs() -> list:
  """Phase 24's models as (label, name, solver, noslip iterations, timed
  steps, checked steps)."""
  out = [(name, name, None, 0, SUITE_STEPS, 5) for name in SUITE_MODELS]
  for name, solver, noslip, steps, checked in SOLVER_FLEETS:
    label = f"{name} {solver}" + (f" + noslip {noslip}" if noslip else "")
    out.append((label, name, solver, noslip, steps, checked))
  return out


def suite_shapes(mt) -> dict:
  """Phase 24's launches, by kernel (``path_shapes``): each model's nv and
  dof blocks at the fleet (4096 fp32) and the 64-lane fp64 runs, the
  solve at one column and, under PGS or noslip, at nefc columns (M⁻¹ Jᵀ of
  the dual); on swimmer15 also the inverse_test's 64 lanes, transition_ad's
  8 lanes (JVPs at 2 nv + nu tangents) and transition_fd's 8 x (2 (2 nv +
  nu) + 1) copies; the multi-column solve timed at (27, 4096, 324),
  (36, 4096, 164) and (6, 6 x 4096, 164) fp32."""
  from mujoco_inversedynamicstest_tpu_torch.ops import constraint, smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  out = {k: set() for k in KERNELS}
  for _, name, solver, noslip, _, _ in suite_configs():
    m = suite_model(mt, name, "cpu", torch.float64, solver, noslip)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    cols = {1}
    if solver == "PGS" or noslip:
      cols.add(constraint.row_layout(m).nefc)
    runs = [(FLEET, torch.float32), (64, torch.float64)]
    if name == "swimmer15":
      nz = derivative.state_dim(m) + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      out["chol_factor_jvp"] |= {(sz, 8 * k, nz, torch.float64)
                                 for sz, k in sizes}
      out["chol_solve_jvp"] |= {(sz, 8 * k, nz, 1, torch.float64)
                                for sz, k in sizes}
    out["chol_factor"] |= {(sz, b * k, dt) for sz, k in sizes
                           for b, dt in runs}
    out["chol_solve"] |= {(sz, b * k, c, dt) for sz, k in sizes
                          for b, dt in runs for c in cols}
  out["chol_solve"] |= {(27, FLEET, 324, torch.float32),
                        (36, FLEET, 164, torch.float32),
                        (6, 6 * FLEET, 164, torch.float32)}
  return out


def time_solve_columns(linalg, dev, n: int, k: int, lanes: int) -> dict:
  """The solve kernel (wrapper included), its plain version and
  torch.cholesky_solve at (lanes, n) fp32 with k right-hand-side columns,
  in turns plain, kernel, library, library, kernel, plain (medians of the
  pairs), beside the bound: L's lower triangle and the k columns read once,
  x written once, 2 n^2 k operations a lane."""
  rng = np.random.default_rng(5)
  l = linalg.chol_factor_ref(spd(rng, lanes, n, dev).float())
  b = torch.as_tensor(rng.standard_normal((lanes, n, k)), device=dev).float()
  tri = lanes * n * (n + 1) // 2
  p1, k1, y1, y2, k2, p2 = (time_ms(f, reps=10) for f in (
      lambda: linalg.chol_solve_ref(l, b), lambda: linalg.chol_solve(l, b),
      lambda: torch.cholesky_solve(b, l), lambda: torch.cholesky_solve(b, l),
      lambda: linalg.chol_solve(l, b), lambda: linalg.chol_solve_ref(l, b)))
  bound, bound_by = bound_ms((tri + 2 * b.numel()) * 4, 2.0 * lanes * n * n * k)
  return {"ms": float(np.median([k1, k2])),
          "plain_ms": float(np.median([p1, p2])), "bound_ms": bound,
          "bound_by": bound_by, "library_ms": float(np.median([y1, y2]))}


@contextlib.contextmanager
def solver_counts():
  """Counts each constraint solve's iterations (CG, Newton) or sweeps
  (PGS), and the noslip pass's sweeps: yields a dict of two lists, to
  which each ``fwd_constraint`` call appends its lanes' counts (the
  noslip's apart)."""
  from mujoco_inversedynamicstest_tpu_torch.ops import noslip, solver

  counts = {"solver": [], "noslip": []}
  inner_solve, inner_noslip = solver.fwd_constraint, noslip.noslip

  def solve(m, d):
    out = inner_solve(m, d)
    counts["solver"].append(out.solver_niter)
    return out

  def sweeps(m, d, *dual):
    out = inner_noslip(m, d, *dual)
    counts["noslip"].append(out.solver_niter - d.solver_niter)
    return out

  solver.fwd_constraint, noslip.noslip = solve, sweeps
  try:
    yield counts
  finally:
    solver.fwd_constraint, noslip.noslip = inner_solve, inner_noslip


def count_text(counts: dict) -> str:
  """A solve's main iterations or sweeps a lane, and its noslip sweeps,
  each mean / max over the solves counted."""
  text = ""
  if counts["solver"]:
    total = torch.stack(counts["solver"]).float()
    main = total - (torch.stack(counts["noslip"]).float()
                    if counts["noslip"] else 0.0)
    text = (f"solver iterations a solve and lane {float(main.mean()):.2f} / "
            f"{int(main.max())}")
  if counts["noslip"]:
    ns = torch.stack(counts["noslip"]).float()
    text += f", noslip sweeps {float(ns.mean()):.2f} / {int(ns.max())}"
  return text


def suite_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 24: the solvers (CG, PGS, noslip), fluid forces and energy.
  Each fleet (4096 fp32 from the tasks' starts; SUITE_STEPS steps of the
  dm_control models, the solver fleets the steps of SOLVER_FLEETS, the
  humanoid under CG and Newton in turns) with its steps/s, finite lanes,
  auto-resets, launches a step, peak memory and solver counts a step; the
  fluid stage's device share of two profiled swimmer15 steps; the solve
  kernel at many columns and the factor at the new n (timed).  Each
  configuration's 5 fp64 steps of 64 lanes with the kernels against 5
  with the plain versions, the fork's inverse_test on swimmer15 (RK4, 64
  lanes fp64) and transition_ad of 8 swimmer15 lanes under EULER and
  IMPLICIT against the plain versions and transition_fd (checks).  Returns
  the kernels' launches of these runs, each read with the counts reset
  before it, and the kernels' timings."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import EnableBit
  from mujoco_inversedynamicstest_tpu_torch.ops import passive
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  phase = "slice: solvers, fluid and energy"
  total = dict.fromkeys(KERNELS, 0)
  times = {}

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  def fleet(label, name, solver, noslip, steps):
    m = suite_model(mt, name, dev, torch.float32, solver, noslip)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d = mt.step(m, suite_data(mt, m, name, FLEET, seed=24))  # warm-up
    torch.cuda.synchronize()
    reset_launches(linalg)
    with solver_counts() as counts:
      t0 = time.perf_counter()
      d = mt.step_n(m, d, steps)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    peak = torch.cuda.max_memory_allocated() / 2**30
    add(launches)
    finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
    resets = int(d.warning.sum())
    energy = ""
    if m.opt.enableflags & EnableBit.ENERGY:
      if not bool(torch.isfinite(d.energy).all()):
        raise AssertionError(f"{label}: non-finite energy")
      energy = (f"; energy (potential, kinetic) mean "
                f"{d.energy.mean(0).tolist()}")
    rate = FLEET * steps / seconds
    log(phase,
        f"{label} (nv {m.nv}) B={FLEET} fp32 {steps} steps in {seconds:.3f} "
        f"s = {rate:.1f} steps/s on {card}; finite lanes {int(finite.sum())} "
        f"of {FLEET}; auto-resets {resets}; launches a step " + ", ".join(
            f"{k} {v / steps:g}" for k, v in launches.items()
            if not k.endswith("_jvp"))
        + f"; peak {peak:.3f} GiB; {count_text(counts)}{energy}")
    if not bool(finite.all()) or resets:
      raise AssertionError(f"{label}: {int((~finite).sum())} non-finite "
                           f"lanes, {resets} auto-resets")
    if not launches["chol_factor"] or not launches["chol_solve"]:
      raise AssertionError(f"{label}: a primal kernel was not launched")
    return m, d, rate

  if TIMED:
    for name in SUITE_MODELS:
      m, d, _ = fleet(name, name, None, 0, SUITE_STEPS)
      if name == "swimmer15":
        step_ms, step_launches, _ = device_profile(
            lambda: mt.step_n(m, d, 2))
        vel = mt.fwd_velocity(m, mt.fwd_position(m, d))
        fluid = lambda: passive.fluid(m, vel)
        fluid()
        fl_ms, fl_launches, _ = device_profile(fluid)
        log("profile: fluid",
            f"swimmer15 B={FLEET} fp32: a step {step_ms / 2:.3f} device ms "
            f"/ {step_launches / 2:.0f} launches; the fluid forces "
            f"{fl_ms:.3f} ms / {fl_launches} launches = "
            f"{fl_ms / (step_ms / 2):.1%} of the step's device time, "
            f"{fl_launches / (step_launches / 2):.1%} of its launches")
    # the humanoid under CG and under Newton in turns: CG, Newton, Newton,
    # CG; then the other solver fleets
    configs = suite_configs()[len(SUITE_MODELS):]
    cg, newton = configs[:2]
    turns = [fleet(*c[:5])[2] for c in (cg, newton, newton, cg)]
    log(phase, "humanoid steps/s in turns CG, Newton, Newton, CG: "
        + ", ".join(f"{r:.1f}" for r in turns) + " (CG / Newton "
        f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.3f})")
    for c in configs[2:]:
      fleet(*c[:5])
    # the solve kernel at the dual solvers' columns (box_stack's path: its
    # six-dof blocks); the factor at the new n
    for n, lanes, k in ((27, FLEET, 324), (36, FLEET, 164),
                        (6, 6 * FLEET, 164)):
      v = time_solve_columns(linalg, dev, n, k, lanes)
      times.setdefault("chol_solve", {"by_n_columns": {}})[
          "by_n_columns"][f"{n}x{k} at {lanes} lanes"] = v
      log("timing", f"chol_solve ({lanes}, {n}) fp32 x {k} columns, ms "
          f"kernel / plain / torch.cholesky_solve / bound: {v['ms']:.4f} / "
          f"{v['plain_ms']:.4f} / {v['library_ms']:.4f} / "
          f"{v['bound_ms']:.4f} ({v['bound_by']}; kernel at "
          f"{v['bound_ms'] / v['ms']:.1%} of it)")
    for n in (17, 13):
      for k, v in time_kernels(linalg, dev, n).items():
        times.setdefault(k, {}).setdefault("by_n", {})[str(n)] = v

  if CHECKS:
    errs = []
    reset_launches(linalg)
    for label, name, solver, noslip, _, checked in suite_configs():
      m = suite_model(mt, name, dev, torch.float64, solver, noslip)
      d_k = d_p = suite_data(mt, m, name, 64, seed=25)
      err = 0.0
      for _ in range(checked):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)
                                ).abs().max())
                         for f in ("qpos", "qvel", "efc_force", "energy")
                         if getattr(d_k, f) is not None))
      if not err <= 1e-9:
        raise AssertionError(f"{label} fp64 steps, kernels vs plain: "
                             f"{err:.3e}")
      errs.append(f"{label} ({checked} steps) {err:.3e}")
    add(read_launches(linalg))
    log(phase, "64 lanes fp64, kernels vs plain, max |dqpos|,|dqvel|,"
        "|defc_force|,|denergy| (tol 1e-9): " + ", ".join(errs))

    # the fork's inverse_test on swimmer15: RK4, fresh forces a step
    m = suite_model(mt, "swimmer15", dev, torch.float64, integrator="RK4")
    add(box_inverse_test(
        mt, linalg, dev, m, phase, "swimmer15", SWIMMER_INVERSE_STEPS,
        seed=26, data=lambda mt, m, b, seed: suite_data(mt, m, "swimmer15",
                                                        b, seed)))

    # transition_ad of 8 swimmer15 lanes, EULER and IMPLICIT
    for integrator in ("EULER", "IMPLICIT"):
      m = suite_model(mt, "swimmer15", dev, torch.float64,
                      integrator=integrator)
      d = suite_data(mt, m, "swimmer15", 8, seed=27)
      d = mt.forward(m, d.replace(qvel=torch.as_tensor(
          0.5 * np.random.RandomState(28).randn(8, m.nv), device=dev)))
      reset_launches(linalg)
      t0 = time.perf_counter()
      ad = derivative.transition_ad(m, d)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
      add(launches)
      with plain_cholesky(linalg):
        plain = derivative.transition_ad(m, d)
      fd = derivative.transition_fd(
          m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
          eps=1e-6, flg_centered=True)
      err_plain = max(float((ad.A - plain.A).abs().max()),
                      float((ad.B - plain.B).abs().max()))
      err_fd = float((ad.A - fd.A).abs().max())
      scale = float(fd.A.abs().max())
      if not err_plain <= 1e-9:
        raise AssertionError(f"transition_ad kernels vs plain: "
                             f"{err_plain:.3e}")
      if not err_fd <= 1e-4 * scale:
        raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
      log(phase,
          f"swimmer15 8 lanes fp64 {integrator}, in the fluid: transition_ad "
          f"{seconds:.3f} s, A {tuple(ad.A.shape)}, B {tuple(ad.B.shape)}; "
          f"kernels vs plain max |dA|,|dB| {err_plain:.3e} (tol 1e-9); vs "
          f"transition_fd (centered, eps 1e-6) max |dA| {err_fd:.3e} = "
          f"{err_fd / scale:.3e} of max|A| {scale:.3e} (tol 1e-4 of it); "
          f"launches {launches}, tangents a lane {read_tangents(linalg)}")
  log(phase, f"phase 24 in {time.perf_counter() - t_phase:.1f} s")
  return total, times

def flex_data(mt, m, name: str, batch: int, seed: int):
  """States of a flex scene, from a seeded numpy generator: each vertex
  (a trilinear cube's node) 0.5 mm randn off its place; the free body at
  rest 1 mm into the sheet or the cube (``FLEX_REST``) with 5 mm of
  uniform noise across; ``flex_self``'s sheet folded as
  ``tests/test_flex_self.py::_folded_state`` folds it (its columns beyond
  x = 0.04 reflected over x = 0.06, 10 mm above the rest); the solid
  cubes lowered 1 mm into the plane (``FLEX_DROP``)."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import JointType

  rng = np.random.RandomState(seed)
  d = mt.make_data(m, batch)
  qpos = d.qpos.cpu().numpy().copy()
  fl = m.flex
  bodies = fl.nodebodyid if np.any(fl.interp) else fl.vertbodyid
  body_pos = m.body_pos.cpu().numpy()
  for b in bodies:
    if not m.body_jntnum[b]:
      continue                                 # a pinned vertex
    adr = m.jnt_qposadr[m.body_jntadr[b]]
    if name == "flex_self" and body_pos[b, 0] > 0.04:
      qpos[:, adr] = (0.12 - body_pos[b, 0]) - body_pos[b, 0]
      qpos[:, adr + 2] = 0.010
    qpos[:, adr + 2] -= FLEX_DROP.get(name, 0.0)
    qpos[:, adr:adr + 3] += 5e-4 * rng.randn(batch, 3)
  for j in np.nonzero(m.jnt_type == JointType.FREE)[0]:
    adr = m.jnt_qposadr[j]
    qpos[:, adr:adr + 2] += rng.uniform(-5e-3, 5e-3, (batch, 2))
    qpos[:, adr + 2] = FLEX_REST[name]
  return d.replace(qpos=torch.as_tensor(qpos, dtype=m.dtype, device=m.device))


def flex_shapes(mt) -> tuple[set, set]:
  """Phase 25's launches, as ``constraint_shapes`` counts them: each
  scene's nv and dof blocks at the fleet (4096 fp32) and at 64 lanes in
  fp32 and fp64 (the contacts against each other, flex_sheet_sphere's
  inverse_test); on flex_cloth and flex_sheet_box transition_ad's 8 lanes
  (JVPs at 2 nv tangents) and transition_fd's 8 x (4 nv + 1) copies."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  primal, jvp = set(), set()
  for name in FLEX_SCENES:
    m = suite_model(mt, name, "cpu", torch.float64)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(FLEET, torch.float32), (64, torch.float32), (64, torch.float64)]
    if name in ("flex_cloth", "flex_sheet_box"):
      nz = derivative.state_dim(m) + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def flex_contact_sets(collision, m, d) -> list:
  """(label, exact, depths) of each element group: exact groups (closed
  forms) give each lane's active depths sorted ascending (+inf where
  inactive), (B, slots); the support-descent groups (a mesh, a cylinder,
  an ellipsoid, self-collision) and the box's SAT manifold on a tet cube,
  whose fp32 answers part from fp64 ones at knife edges by up to the
  descent's accuracy, give each lane's deepest active depth, (B, 1).
  The geom pairs' (flex vertices on a plane) come first, as
  ``contact_sets``."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType

  lay = collision.contact_layout(m)
  dist = torch.where(d.contact.dist < d.contact.includemargin,
                     d.contact.dist.double(), float("inf"))
  out = ([("geom pairs", True, contact_sets(collision, m, d)[0].flatten(1))]
         if lay.groups else [])
  start = sum(len(g.geom1) * g.nslot for g in lay.groups)
  for eg in lay.elem_groups:
    n = eg.npair_run * eg.nslot
    group = torch.sort(dist[:, start:start + n], dim=-1).values
    start += n
    descent = eg.kind == "selfpair" or eg.gtype in (
        GeomType.MESH, GeomType.CYLINDER, GeomType.ELLIPSOID) or (
            eg.gtype == GeomType.BOX and m.flex.dim[eg.flexid] == 3)
    label = eg.kind + ("" if eg.gtype < 0 else
                       f" {GeomType(eg.gtype).name.lower()}")
    out.append((label, not descent, group[:, :1] if descent else group))
  return out


def time_jvp_kernels(linalg, dev, n: int, b: int, t: int,
                     dtype=torch.float64) -> dict:
  """The two JVP kernels (wrapper included) at (b lanes, n) in ``dtype``
  (fp64 unless given) with t tangents a lane, against their plain versions
  and the vmap-of-jvp yardstick, in turns plain, kernel, library, library,
  kernel, plain (medians of the pairs), beside the bound (``jvp_work``, at
  the dtype's rate)."""
  rng = np.random.default_rng(6)
  h = spd(rng, b, n, dev).to(dtype)
  dh = sym(rng, (t, b, n, n), dev).to(dtype)
  l = linalg.chol_factor_ref(h)
  dl = linalg.chol_factor_jvp_ref(l, dh)
  x = torch.as_tensor(rng.standard_normal((b, n)), device=dev).to(dtype)
  db = torch.as_tensor(rng.standard_normal((t, b, n)), device=dev).to(dtype)
  work = jvp_work(n, b, t, h.element_size())
  vj = lambda f, p, tg: torch.func.vmap(
      lambda *u: torch.func.jvp(f, p, u)[1])(*tg)
  out = {}
  for name, kern, plain, library in (
      ("chol_factor_jvp", lambda: linalg.chol_factor_jvp(l, dh),
       lambda: linalg.chol_factor_jvp_ref(l, dh),
       lambda: vj(torch.linalg.cholesky, (h,), (dh,))),
      ("chol_solve_jvp", lambda: linalg.chol_solve_jvp(l, dl, x, db),
       lambda: linalg.chol_solve_jvp_ref(l, dl, x, db),
       lambda: vj(lambda a, r: torch.cholesky_solve(r, a),
                  (l, x[..., None]), (dl, db[..., None])))):
    p1, k1, y1, y2, k2, p2 = (time_ms(f, reps=10) for f in (
        plain, kern, library, library, kern, plain))
    bound, bound_by = bound_ms(*work[name], fp64=dtype == torch.float64)
    out[name] = {"ms": float(np.median([k1, k2])),
                 "plain_ms": float(np.median([p1, p2])),
                 "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": float(np.median([y1, y2]))}
  log("timing: JVP kernels", f"({b} lanes, {t} tangents, {n}) "
      f"{str(dtype)[6:].replace('float', 'fp')}, ms "
      "kernel / plain / vmap-of-jvp yardstick / bound: " + ", ".join(
          f"{k} {v['ms']:.4f} / {v['plain_ms']:.4f} / {v['library_ms']:.4f}"
          f" / {v['bound_ms']:.5f} ({v['bound_by']})"
          for k, v in out.items()))
  return out


def flex_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 25: the flex scenes.  Each fleet (4096 fp32 from
  ``flex_data``'s states; the cloth CLOTH_STEPS steps, the rest
  FLEX_STEPS) with its steps/s, finite lanes, auto-resets, active slots a
  lane, launches a step, peak memory, and the flex collision's device ms
  and launches against a step's; the kernels timed at the scenes' nv
  (fp32, 4096 lanes) and the JVP kernels at transition_ad's shapes (fp64).
  Then (checks) the fp32 contacts of 64 states of each scene with contacts
  against fp64 (active sets equal, depths within 1e-4), the fork's
  inverse_test on flex_sheet_sphere (RK4, 64 lanes fp64, fresh forces a
  step) and transition_ad of 8 lanes of flex_cloth and flex_sheet_box
  against the plain versions and transition_fd.  Returns the kernels'
  launches of these runs and the timings."""
  from mujoco_inversedynamicstest_tpu_torch.ops import collision
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  phase = "slice: flex"
  total = dict.fromkeys(KERNELS, 0)
  times = {}

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  if TIMED:
    for name in FLEX_SCENES:
      steps = CLOTH_STEPS if name == "flex_cloth" else FLEX_STEPS
      m = suite_model(mt, name, dev, torch.float32)
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      d = mt.step(m, flex_data(mt, m, name, FLEET, seed=25))  # warm-up
      torch.cuda.synchronize()
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, d, steps)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      peak = torch.cuda.max_memory_allocated() / 2**30
      add(launches)
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      resets = int(d.warning.sum())
      active = (0.0 if d.contact is None else float(
          (d.contact.dist < d.contact.includemargin).sum(1).float().mean()))
      step_ms, step_launches, _ = device_profile(lambda: mt.step(m, d))
      if d.contact is None:
        col = "no contacts (contact disabled)"
      else:
        pos = mt.fwd_position(m, d)
        col_ms, col_launches, _ = device_profile(
            lambda: collision.collision(m, pos))
        col = (f"collision {col_ms:.3f} device ms / {col_launches} launches "
               f"= {col_ms / step_ms:.1%} / "
               f"{col_launches / step_launches:.1%} of a step's")
      log(phase,
          f"{name} (nv {m.nv}, {collision.contact_layout(m).ncon} slots) "
          f"B={FLEET} fp32 {steps} steps in {seconds:.3f} s = "
          f"{FLEET * steps / seconds:.1f} steps/s on {card}; finite lanes "
          f"{int(finite.sum())} of {FLEET}; auto-resets {resets}; active "
          f"slots a lane {active:.2f}; launches a step " + ", ".join(
              f"{k} {v / steps:g}" for k, v in launches.items()
              if not k.endswith("_jvp"))
          + f"; peak {peak:.3f} GiB; a step {step_ms:.3f} device ms / "
          f"{step_launches} launches; {col}")
      if not bool(finite.all()) or resets:
        raise AssertionError(f"{name}: {int((~finite).sum())} non-finite "
                             f"lanes, {resets} auto-resets")
      if not launches["chol_factor"] or not launches["chol_solve"]:
        raise AssertionError(f"{name}: a primal kernel was not launched")
    for n in FLEX_NV:
      for k, v in time_kernels(linalg, dev, n).items():
        times.setdefault(k, {}).setdefault("by_n", {})[str(n)] = v
    for name in ("flex_cloth", "flex_sheet_box"):
      m = suite_model(mt, name, "cpu", torch.float64)
      nz = derivative.state_dim(m) + m.nu
      for k, v in time_jvp_kernels(linalg, dev, m.nv, 8, nz).items():
        times.setdefault(k, {}).setdefault("by_shape", {})[
            f"({m.nv}, 8 lanes, {nz} tangents) fp64"] = v

  if CHECKS:
    # fp32 contacts against fp64 on the same 64 states
    rows = []
    for name in FLEX_SCENES[1:]:
      m32 = suite_model(mt, name, dev, torch.float32)
      m64 = suite_model(mt, name, dev, torch.float64)
      d32 = flex_data(mt, m32, name, 64, seed=26)
      d64 = flex_data(mt, m64, name, 64, seed=26)
      p32, p64 = mt.fwd_position(m32, d32), mt.fwd_position(m64, d64)
      s32 = flex_contact_sets(collision, m32, p32)
      s64 = flex_contact_sets(collision, m64, p64)
      parted = int(((p32.contact.dist < p32.contact.includemargin)
                    != (p64.contact.dist < p64.contact.includemargin)).sum())
      for (label, exact, a), (_, _, b) in zip(s32, s64):
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
          raise AssertionError(f"{name} {label}: fp32 and fp64 active "
                               f"{'sets' if exact else 'deepest'} differ")
        live = torch.isfinite(b)
        worst = float((a - b)[live].abs().max()) if bool(live.any()) else 0.0
        if not worst <= 1e-4:
          raise AssertionError(f"{name} {label}: fp32 depths {worst:.3e} "
                               "from fp64")
        rows.append(f"{name} {label}: {int(live.sum()) / 64:.2f} a lane "
                    f"{'active' if exact else 'with a deepest'}, "
                    f"{worst:.3e}")
      rows[-1] += f" ({parted} slots active in one precision only)"
    log(phase, "fp32 contacts of 64 states against fp64, closed forms: "
        "active sets equal, max |ddepth|; descent and the tets' SAT "
        "manifold: each lane's deepest contact (tol 1e-4): "
        + "; ".join(rows))

    # the fork's inverse_test on flex_sheet_sphere: RK4, fresh forces a
    # step, 0.01 randn (a vertex body weighs 8 g: 0.3 N would throw the
    # sheet off the sphere within the run)
    m = suite_model(mt, "flex_sheet_sphere", dev, torch.float64,
                    integrator="RK4")
    add(box_inverse_test(
        mt, linalg, dev, m, phase, "flex_sheet_sphere", FLEX_INVERSE_STEPS,
        seed=27, data=lambda mt, m, b, seed: flex_data(
            mt, m, "flex_sheet_sphere", b, seed), scale=0.01))

    # transition_ad of 8 lanes: the cloth's elasticity, the box's weighted
    # contact rows
    for name in ("flex_cloth", "flex_sheet_box"):
      m = suite_model(mt, name, dev, torch.float64)
      d = flex_data(mt, m, name, 8, seed=28)
      d = mt.forward(m, d.replace(qvel=torch.as_tensor(
          0.05 * np.random.RandomState(29).randn(8, m.nv), device=dev)))
      reset_launches(linalg)
      t0 = time.perf_counter()
      ad = derivative.transition_ad(m, d)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
      add(launches)
      with plain_cholesky(linalg):
        plain = derivative.transition_ad(m, d)
      fd = derivative.transition_fd(
          m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
          eps=1e-6, flg_centered=True)
      err_plain = float((ad.A - plain.A).abs().max())
      err_fd = float((ad.A - fd.A).abs().max())
      scale = float(fd.A.abs().max())
      if not err_plain <= 1e-9:
        raise AssertionError(f"transition_ad kernels vs plain: "
                             f"{err_plain:.3e}")
      if not err_fd <= 1e-4 * scale:
        raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e}")
      log(phase,
          f"{name} 8 lanes fp64: transition_ad {seconds:.3f} s, A "
          f"{tuple(ad.A.shape)}; kernels vs plain max |dA| {err_plain:.3e} "
          f"(tol 1e-9); vs transition_fd (centered, eps 1e-6) max |dA| "
          f"{err_fd:.3e} = {err_fd / scale:.3e} of max|A| {scale:.3e} (tol "
          f"1e-4 of it); launches {launches}, tangents a lane "
          f"{read_tangents(linalg)}")
  log(phase, f"phase 25 in {time.perf_counter() - t_phase:.1f} s")
  return total, times


def tail_data(mt, m, name: str, batch: int, seed: int,
              upright: bool = False):
  """Phase 26's states, from a seeded numpy generator.  The quadrupeds:
  the walk task's starts (``quadruped_data``), or where ``upright`` each
  standing on its toes (a random yaw, a 0.05 randn tilt, the hinges 0.1
  randn about qpos0, lowered 1 mm into the floor).  The adhesion sphere
  resting on the floor, rising at up to 0.5 m/s, its control uniform in
  its range; sensor_limits swung by 1.2 randn (limits active); the other
  scenes qpos0 moved by 0.3 randn in each dof's tangent direction.  qvel
  0.3 randn and controls uniform in their range, where not said."""
  if name.startswith("quadruped") and not upright:
    return quadruped_data(mt, m, "quadruped", batch, seed)
  rng = np.random.RandomState(seed)
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
  d = mt.make_data(m, batch)
  lo, hi = m.actuator_ctrlrange.cpu().numpy().T
  ctrl = t(rng.uniform(lo, hi, (batch, m.nu)))
  if name.startswith("quadruped"):
    yaw = rng.uniform(0, 2 * np.pi, batch)
    q = np.c_[np.cos(yaw / 2), 0.05 * rng.randn(batch, 2), np.sin(yaw / 2)]
    qpos = d.qpos.cpu().numpy().copy()
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 7:] += 0.1 * rng.randn(batch, m.nq - 7)
    d = d.replace(qpos=t(qpos), qvel=t(0.05 * rng.randn(batch, m.nv)),
                  ctrl=ctrl)
    return drop_onto(mt, m, d, lambda x, y: np.zeros_like(x), -0.001)
  if name == "transmission_adhesion":
    qvel = np.zeros((batch, m.nv))
    qvel[:, 2] = rng.uniform(0, 0.5, batch)
    return d.replace(qvel=t(qvel), ctrl=ctrl)
  scale = 1.2 if name == "sensor_limits" else 0.3
  return d.replace(
      qpos=mt.integrate_pos(m, d.qpos, t(scale * rng.randn(batch, m.nv)), 1.0),
      qvel=t(0.3 * rng.randn(batch, m.nv)), ctrl=ctrl)


def tail_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 26: the sensor tail and the transmissions.  dm_control's
  quadruped with its 20 rangefinders and phase 23's quadruped from the same
  walk-task starts (4096 fp32, RANGEFINDER_STEPS EULER steps after a
  warm-up step), in turns rangefinder, plain, plain, rangefinder; the
  sensor stage's and the rays' device ms and launches against a step's;
  the transmission scenes' fleets; the kernels timed at the quadruped's nv
  and at transition_ad's JVP shape (timed).  The fp32 rays of 64 states
  against fp64; each model's 5 fp64 steps of 64 lanes with the kernels
  against 5 with the plain versions; transition_ad(flg_sensor=True) of 8
  upright lanes against the plain versions and transition_fd (checks).
  Returns the kernels' launches of these runs, each read with the counts
  reset before it, and the kernels' timings."""
  from mujoco_inversedynamicstest_tpu_torch.models.types import SensorType
  from mujoco_inversedynamicstest_tpu_torch.ops import ray, sensor
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  phase = "slice: sensor tail"
  total = dict.fromkeys(KERNELS, 0)
  times = {}

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  model = lambda name, dtype: contact_model(mt, name, dev, dtype, cone=None)

  def rays(m, d):
    sites = m.sensor_objid[m.sensor_type == SensorType.RANGEFINDER]
    s = m.const(sites)
    return ray.ray(m, d, d.site_xpos[:, s], d.site_xmat[:, s, :, 2],
                   bodyexclude=m.site_bodyid[sites])

  if TIMED:
    names = ("quadruped_rangefinder", "quadruped")
    models = {name: model(name, torch.float32) for name in names}
    d0 = tail_data(mt, models["quadruped"], "quadruped", FLEET, seed=23)
    starts = {"quadruped": d0, "quadruped_rangefinder": mt.make_data(
        models["quadruped_rangefinder"], FLEET).replace(
            qpos=d0.qpos, qvel=d0.qvel, ctrl=d0.ctrl)}
    starts = {n: mt.step(models[n], d) for n, d in starts.items()}
    torch.cuda.synchronize()
    rates = {name: [] for name in names}
    rf = models["quadruped_rangefinder"].sensor_type == SensorType.RANGEFINDER
    rf_adr = models["quadruped_rangefinder"].sensor_adr[rf]
    for name in names + names[::-1]:
      m = models[name]
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, starts[name], RANGEFINDER_STEPS)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      rates[name].append(FLEET * RANGEFINDER_STEPS / seconds)
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      if not bool(finite.all()):
        raise AssertionError(f"{name}: {int((~finite).sum())} non-finite "
                             "lanes")
      for k in ("chol_factor", "chol_solve"):
        if not launches[k]:
          raise AssertionError(f"{k} was not launched on {name}")
      extra = ""
      if name == "quadruped_rangefinder":
        add(launches)
        if not bool(torch.isfinite(d.sensordata).all()):
          raise AssertionError("non-finite sensordata")
        reading = d.sensordata[:, m.const(rf_adr)]
        extra = (f"; sensordata finite; rangefinders hitting "
                 f"{float((reading >= 0).float().mean()):.1%}, reading -1 "
                 f"{float((reading == -1).float().mean()):.1%}")
      log(phase,
          f"{name} B={FLEET} fp32 EULER: {RANGEFINDER_STEPS} steps in "
          f"{seconds:.3f} s = {rates[name][-1]:.1f} steps/s on {card}; "
          "launches a step " + ", ".join(
              f"{k} {v / RANGEFINDER_STEPS:g}" for k, v in launches.items()
              if not k.endswith("_jvp"))
          + f"; finite lanes {int(finite.sum())} of {FLEET}; auto-resets "
          f"{int(d.warning.sum())}" + extra)
    med = {name: float(np.median(r)) for name, r in rates.items()}
    m, d = models["quadruped_rangefinder"], starts["quadruped_rangefinder"]
    step_ms, step_launches, _ = device_profile(lambda: mt.step_n(m, d, 2))
    step_ms, step_launches = step_ms / 2, step_launches / 2
    fwd = mt.forward(m, d)
    stage = lambda: sensor.sensor_acc(m, sensor.sensor_vel(
        m, sensor.sensor_pos(m, fwd)))
    cast = lambda: rays(m, fwd)
    parts = {}
    for part, fn in (("sensor stage", stage), ("rangefinder cast", cast)):
      fn()
      parts[part] = device_profile(fn)[:2]
    log("profile: sensor tail",
        f"steps/s medians: with rangefinders {med[names[0]]:.1f}, phase 23's "
        f"quadruped {med[names[1]]:.1f} ({med[names[0]] / med[names[1]]:.3f}"
        f"x); 2 profiled steps with rangefinders: device {step_ms:.3f} ms / "
        f"{step_launches:.0f} launches a step; " + "; ".join(
            f"{part} {ms:.3f} ms / {nl} launches = {ms / step_ms:.1%} of the "
            f"step's device time, {nl / step_launches:.1%} of its launches"
            for part, (ms, nl) in parts.items()))
    for name in TRANSMISSION_SCENES:
      m = model(name, torch.float32)
      d, seconds, launches = timed_fleet(
          mt, linalg, m, tail_data(mt, m, name, FLEET, seed=26),
          TRANSMISSION_STEPS)
      add(launches)
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      if not bool(finite.all()):
        raise AssertionError(f"{name}: {int((~finite).sum())} non-finite "
                             "lanes")
      if not launches["chol_factor"] or not launches["chol_solve"]:
        raise AssertionError(f"{name}: a primal kernel was not launched")
      extra = ""
      if name == "transmission_adhesion":
        held = (d.qpos[:, 2] - 0.099).abs() < 0.005
        extra = (f"; the sphere on the floor on {float(held.float().mean()):.1%}"
                 " of lanes (controls uniform in 0-5, rising at up to 0.5 "
                 "m/s)")
      log(phase,
          f"{name} (nv {m.nv}) B={FLEET} fp32: {TRANSMISSION_STEPS} steps in "
          f"{seconds:.3f} s = {FLEET * TRANSMISSION_STEPS / seconds:.1f} "
          f"steps/s on {card}; finite lanes {int(finite.sum())} of {FLEET}; "
          f"auto-resets {int(d.warning.sum())}; launches a step " + ", ".join(
              f"{k} {v / TRANSMISSION_STEPS:g}" for k, v in launches.items()
              if not k.endswith("_jvp")) + extra)
    m = model("quadruped_rangefinder", torch.float32)
    for k, v in time_kernels(linalg, dev, m.nv).items():
      times.setdefault(k, {}).setdefault("by_shape", {})[
          f"({FLEET}, {m.nv}) fp32, phase 26"] = v
    nz = derivative.state_dim(m) + m.nu
    for k, v in time_jvp_kernels(linalg, dev, m.nv, 8, nz).items():
      times.setdefault(k, {}).setdefault("by_shape", {})[
          f"({m.nv}, 8 lanes, {nz} tangents) fp64, phase 26"] = v

  if CHECKS:
    # the fp32 rangefinders of 64 states against fp64
    m64 = model("quadruped_rangefinder", torch.float64)
    m32 = model("quadruped_rangefinder", torch.float32)
    d64 = tail_data(mt, m64, "quadruped", 64, seed=24)
    d32 = mt.make_data(m32, 64).replace(qpos=d64.qpos.float())
    reset_launches(linalg)
    dist64, geom64 = rays(m64, mt.fwd_position(m64, d64))
    dist32, geom32 = rays(m32, mt.fwd_position(m32, d32))
    add(read_launches(linalg))
    graze = geom64 != geom32
    err = float((dist64 - dist32.double())[~graze].abs().max())
    if not err <= 1e-4 or int(graze.sum()) > GRAZE_SHARE * graze.numel():
      raise AssertionError(f"fp32 rays against fp64: max |ddist| {err:.3e}, "
                           f"{int(graze.sum())} hit another geom")
    rays_line = (f"the fp32 rangefinders of 64 walk-task starts against "
                 f"fp64: {int(graze.sum())} of {graze.numel()} rays graze a "
                 f"silhouette (hit another geom; at most "
                 f"{GRAZE_SHARE:.0%}), the rest hit the same geom, max "
                 f"|ddist| {err:.3e} m (tol 1e-4), {int((geom64 >= 0).sum())}"
                 " hit")

    # the kernels against the plain versions, 64 lanes fp64, 5 steps
    errs = []
    for name in ("quadruped_rangefinder",) + TRANSMISSION_SCENES + TAIL_SCENES:
      m = model(name, torch.float64)
      d_k = d_p = tail_data(mt, m, name, 64, seed=25)
      fields = ["qpos", "qvel"] + (["sensordata"] if m.nsensordata else []) + (
          ["actuator_length"] if m.nu else [])
      reset_launches(linalg)
      err = 0.0
      for _ in range(5):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)
                                ).abs().max()) for f in fields))
      add(read_launches(linalg))
      if not err <= 1e-9 or not all(bool(torch.isfinite(getattr(d_k, f)).all())
                                    for f in fields):
        raise AssertionError(f"{name} fp64 steps, kernels vs plain: "
                             f"{err:.3e}")
      errs.append(f"{name} {err:.3e}")
    log(phase, rays_line + "; 64 lanes fp64, 5 steps, kernels vs plain, max "
        "|dqpos|,|dqvel|,|dsensordata|,|dactuator_length| (tol 1e-9): "
        + ", ".join(errs))

    # C, D of 8 upright lanes, standing on their toes
    m = model("quadruped_rangefinder", torch.float64)
    d = mt.forward(m, tail_data(mt, m, "quadruped_rangefinder", 8, seed=27,
                                upright=True))
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m, d, flg_sensor=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    add(launches)
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m, d, flg_sensor=True)
    fd = derivative.transition_fd(
        m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True, flg_sensor=True)
    err_plain = max(float((getattr(ad, f) - getattr(plain, f)).abs().max())
                    for f in "ABCD")
    # C's rangefinder rows apart as well: the force sensors' rows, through
    # the contacts' stiffness, are 1e6 times larger
    rows = m.const(m.sensor_adr[m.sensor_type == SensorType.RANGEFINDER])
    parts = {"C": (ad.C, fd.C), "D": (ad.D, fd.D),
             "C's rangefinder rows": (ad.C[:, rows], fd.C[:, rows])}
    err_fd = {f: float((a - b).abs().max()) for f, (a, b) in parts.items()}
    scale = {f: float(b.abs().max()) for f, (_, b) in parts.items()}
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    for f in parts:
      if not err_fd[f] <= 1e-4 * scale[f]:
        raise AssertionError(f"{f} vs transition_fd: {err_fd[f]:.3e} of "
                             f"max|{f}| {scale[f]:.3e}")
    if not scale["C's rangefinder rows"] > 0:
      raise AssertionError("the rangefinders' C rows are zero")
    ncon = int((d.contact.dist < d.contact.includemargin).sum())
    log(phase,
        f"quadruped_rangefinder 8 lanes fp64 EULER, upright on their toes, "
        f"{ncon} active contacts: transition_ad(flg_sensor=True) "
        f"{seconds:.3f} s, C {tuple(ad.C.shape)}, D {tuple(ad.D.shape)}; "
        f"kernels vs plain max |dA|,|dB|,|dC|,|dD| {err_plain:.3e} (tol "
        "1e-9); vs transition_fd (centered, eps 1e-6) " + ", ".join(
            f"{f} {err_fd[f]:.3e} = {err_fd[f] / max(scale[f], 1e-300):.3e} "
            f"of their max {scale[f]:.3e} (tol 1e-4 of it)" for f in parts)
        + " (D is 0 where the controls reach the sensors only through the "
        "activations, as the quadruped's filtered actuators do)"
        + f"; launches {launches}, tangents a lane {read_tangents(linalg)}")
  log(phase, f"phase 26 in {time.perf_counter() - t_phase:.1f} s")
  return total, times


def _quat_np(axis: str, deg: float) -> np.ndarray:
  """The unit quaternion of a rotation by ``deg`` about axis x, y or z."""
  q = np.zeros(4)
  q[0] = np.cos(np.deg2rad(deg) / 2)
  q["xyz".index(axis) + 1] = np.sin(np.deg2rad(deg) / 2)
  return q


def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
  """Hamilton products of quaternions (..., 4), host float64."""
  w1, v1, w2, v2 = a[..., :1], a[..., 1:], b[..., :1], b[..., 1:]
  return np.concatenate([w1 * w2 - np.sum(v1 * v2, -1, keepdims=True),
                         w1 * v2 + w2 * v1 + np.cross(v1, v2)], axis=-1)


def _small_turns(rng, batch: int, scale: float) -> np.ndarray:
  """(batch, 4) rotations by ``scale`` randn about random axes."""
  axis = rng.randn(batch, 3)
  axis /= np.linalg.norm(axis, axis=1, keepdims=True)
  angle = scale * rng.randn(batch, 1)
  return np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * axis], 1)


def plugin_data(mt, m, name: str, batch: int, seed: int):
  """Phase 27's states, from a seeded numpy generator.  The cable bent as
  tests/test_plugins.py bends it (each ball joint up to 0.25 rad about a
  random axis, qvel 0.1 randn); the PID hinge at 0.3 randn with 0.3 randn
  velocity and controls uniform in +-1; the touch grid's sphere 2 mm into
  the plane (the test presses it 6 cm, from which it leaves the plane
  within 10 steps), 1 mm randn up or down and 1 cm randn across, sliding
  at 0.1 randn.  The SDF scenes' free body on
  its SDF: the sphere on the torus's top (0-5 mm below its resting height,
  1.0925 m), the torus crossing the fixed torus at its top (rings at right
  angles, 0.05 rad randn tilt), the ball at the bowl's bottom and the
  sphere on the sdflib cube (0-5 mm into them), each moved 1-5 cm randn
  across."""
  rng = np.random.RandomState(seed)
  d = mt.make_data(m, batch)
  t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)
  qpos = d.qpos.cpu().numpy().copy()
  qvel = np.zeros((batch, m.nv))
  ctrl = np.zeros((batch, m.nu))
  if name == "plugin_cable":
    for j in np.nonzero(m.jnt_type == 1)[0]:         # the ball joints
      adr = m.jnt_qposadr[j]
      axis = rng.randn(batch, 3)
      axis /= np.linalg.norm(axis, axis=1, keepdims=True)
      ang = 0.25 * rng.rand(batch, 1)
      qpos[:, adr:adr + 4] = np.c_[np.cos(ang / 2), np.sin(ang / 2) * axis]
    qvel = 0.1 * rng.randn(batch, m.nv)
  elif name == "plugin_pid":
    qpos += 0.3 * rng.randn(batch, m.nq)
    qvel = 0.3 * rng.randn(batch, m.nv)
    ctrl = rng.uniform(-1.0, 1.0, (batch, m.nu))
  elif name == "plugin_touch_grid":
    qpos[:, 0] += 0.058 + 1e-3 * rng.randn(batch)
    qpos[:, 1] += 1e-2 * rng.randn(batch)
    qvel = 0.1 * rng.randn(batch, m.nv)
  else:
    rest = {"sdf_torus": (1.0925, 0.01), "sdf_torus_pair": (1.485, 0.02),
            "sdf_bowl": (0.165, 0.05), "sdflib_cube": (0.148, 0.03)}[name]
    qpos[:, :2] = rest[1] * rng.randn(batch, 2)
    qpos[:, 2] = rest[0] - 0.005 * rng.rand(batch)
    if name == "sdf_torus_pair":
      ring = _quat_mul_np(_quat_np("x", 90), _quat_np("z", 90))
      qpos[:, 3:7] = _quat_mul_np(ring, _small_turns(rng, batch, 0.05))
  return d.replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))


def plugin_shapes(mt) -> tuple[set, set]:
  """Phase 27's launches, as ``constraint_shapes`` counts them: each
  scene's nv and dof blocks at the fleet (4096 fp32), at 64 lanes in fp64
  (kernels against plain versions, the inverse_tests, the contacts) and
  fp32 (the SDF contacts, the touch grid); on sdf_torus transition_ad's 8
  lanes (JVPs at 2 nv + na + nu tangents) and transition_fd's 8 x (2 (2 nv
  + na + nu) + 1) copies."""
  from mujoco_inversedynamicstest_tpu_torch.ops import smooth
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  primal, jvp = set(), set()
  for name in PLUGIN_SCENES + SDF_SCENES:
    m = suite_model(mt, name, "cpu", torch.float64)
    blocks = smooth._dof_blocks(m)
    sizes = {(m.nv, 1)} | ({(sz, len(st)) for sz, st in blocks.items()}
                           if blocks else set())
    runs = [(FLEET, torch.float32), (64, torch.float64), (64, torch.float32)]
    if name == "sdf_torus":
      nz = derivative.state_dim(m) + m.nu
      runs += [(8, torch.float64), (8 * (2 * nz + 1), torch.float64)]
      jvp |= {(sz, 8 * k, nz, torch.float64) for sz, k in sizes}
    primal |= {(sz, b * k, dt) for sz, k in sizes for b, dt in runs}
  return primal, jvp


def deepest_contact(d) -> torch.Tensor:
  """(B,) each lane's deepest active contact distance, +inf without."""
  con = d.contact
  return torch.where(con.dist < con.includemargin, con.dist.double(),
                     float("inf")).amin(1)


def plugin_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 27: the engine plugins (PID, cable, touch grid) and the SDF
  plugin geoms (torus, bowl, the mesh-SDF cube).  Each fleet (4096 fp32
  from ``plugin_data``'s states; PLUGIN_STEPS steps, the SDF scenes
  SDF_STEPS) with its steps/s, finite lanes, auto-resets, launches and
  factorizations a step, peak memory, a step's device ms and launches
  and, on the SDF scenes, collision's against it; the kernels timed at the
  scenes' nv and the JVP kernels at transition_ad's shape.  Then (checks) each model's 5 fp64 steps of 64 lanes with
  the kernels against 5 with the plain versions; the fp32 deepest SDF
  contact of 64 states against fp64; the touch grid's fp32 readings
  against fp64; the fork's inverse_test on the cable (EULER) and the bowl
  (RK4), 64 lanes fp64, fresh forces a step; transition_ad of 8 lanes of the
  sphere resting on the torus against the plain versions and
  transition_fd.  Returns the kernels' launches of these runs and the
  timings."""
  from mujoco_inversedynamicstest_tpu_torch.ops import collision
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative

  t_phase = time.perf_counter()
  phase = "slice: plugins"
  total = dict.fromkeys(KERNELS, 0)
  times = {}

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  if TIMED:
    for name in PLUGIN_SCENES + SDF_SCENES:
      steps = SDF_STEPS if name in SDF_SCENES else PLUGIN_STEPS
      m = suite_model(mt, name, dev, torch.float32)
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      d = mt.step(m, plugin_data(mt, m, name, FLEET, seed=27))  # warm-up
      torch.cuda.synchronize()
      reset_launches(linalg)
      t0 = time.perf_counter()
      d = mt.step_n(m, d, steps)
      torch.cuda.synchronize()
      seconds = time.perf_counter() - t0
      launches = read_launches(linalg)
      peak = torch.cuda.max_memory_allocated() / 2**30
      add(launches)
      finite = torch.isfinite(d.qpos).all(1) & torch.isfinite(d.qvel).all(1)
      resets = int(d.warning.sum())
      step_ms, step_launches, _ = device_profile(lambda: mt.step(m, d))
      extra = ""
      if name in SDF_SCENES:
        pos = mt.fwd_position(m, d)
        col_ms, col_launches, _ = device_profile(
            lambda: collision.collision(m, pos))
        touching = float(torch.isfinite(deepest_contact(pos)).float().mean())
        extra = (f"; collision {col_ms:.3f} device ms / {col_launches} "
                 f"launches = {col_ms / step_ms:.1%} / "
                 f"{col_launches / step_launches:.1%} of a step's; lanes in "
                 f"contact {touching:.1%}")
      elif m.nsensordata:
        extra = (f"; sensordata finite {bool(torch.isfinite(d.sensordata).all())}"
                 f", lanes reading > 0 "
                 f"{float((d.sensordata.abs().sum(1) > 0).float().mean()):.1%}")
      log(phase,
          f"{name} (nv {m.nv}, plugins {[h.name for h in m.plugin_hooks]}) "
          f"B={FLEET} fp32 {steps} steps in {seconds:.3f} s = "
          f"{FLEET * steps / seconds:.1f} steps/s on {card}; finite lanes "
          f"{int(finite.sum())} of {FLEET}; auto-resets {resets}; launches "
          "a step " + ", ".join(
              f"{k} {v / steps:g}" for k, v in launches.items()
              if not k.endswith("_jvp"))
          + f"; peak {peak:.3f} GiB; a step {step_ms:.3f} device ms / "
          f"{step_launches} launches" + extra)
      if not bool(finite.all()) or resets:
        raise AssertionError(f"{name}: {int((~finite).sum())} non-finite "
                             f"lanes, {resets} auto-resets")
      if not launches["chol_factor"] or not launches["chol_solve"]:
        raise AssertionError(f"{name}: a primal kernel was not launched")
      if name in SDF_SCENES and not touching > 0:
        raise AssertionError(f"{name}: no lane in contact")
    for n in PLUGIN_NV:
      for k, v in time_kernels(linalg, dev, n).items():
        times.setdefault(k, {}).setdefault("by_shape", {})[
            f"({FLEET}, {n}) fp32, phase 27"] = v
    m = suite_model(mt, "sdf_torus", "cpu", torch.float64)
    nz = derivative.state_dim(m) + m.nu
    for k, v in time_jvp_kernels(linalg, dev, m.nv, 8, nz).items():
      times.setdefault(k, {}).setdefault("by_shape", {})[
          f"({m.nv}, 8 lanes, {nz} tangents) fp64, phase 27"] = v

  if CHECKS:
    # the kernels against the plain versions, 64 lanes fp64, 5 steps
    errs = []
    for name in PLUGIN_SCENES + SDF_SCENES:
      m = suite_model(mt, name, dev, torch.float64)
      d_k = d_p = plugin_data(mt, m, name, 64, seed=28)
      fields = ["qpos", "qvel"] + (["act"] if m.na else []) + (
          ["sensordata"] if m.nsensordata else [])
      reset_launches(linalg)
      err = 0.0
      for _ in range(5):
        d_k = mt.step(m, d_k)
        with plain_cholesky(linalg):
          d_p = mt.step(m, d_p)
        err = max(err, *(float((getattr(d_k, f) - getattr(d_p, f)
                                ).abs().max()) for f in fields))
      add(read_launches(linalg))
      if not err <= 1e-9 or not all(bool(torch.isfinite(getattr(d_k, f)).all())
                                    for f in fields):
        raise AssertionError(f"{name} fp64 steps, kernels vs plain: "
                             f"{err:.3e}")
      errs.append(f"{name} {err:.3e}")
    log(phase, "64 lanes fp64, 5 steps, kernels vs plain, max "
        "|dqpos|,|dqvel|,|dact|,|dsensordata| (tol 1e-9): " + ", ".join(errs))

    # the fp32 deepest SDF contact of 64 states against fp64
    rows = []
    reset_launches(linalg)
    for name in SDF_SCENES:
      m32 = suite_model(mt, name, dev, torch.float32)
      m64 = suite_model(mt, name, dev, torch.float64)
      d64 = plugin_data(mt, m64, name, 64, seed=29)
      d32 = mt.make_data(m32, 64).replace(qpos=d64.qpos.float())
      a = deepest_contact(mt.fwd_position(m32, d32))
      b = deepest_contact(mt.fwd_position(m64, d64))
      if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError(f"{name}: fp32 and fp64 lanes in contact "
                             "differ")
      live = torch.isfinite(b)
      worst = float((a - b)[live].abs().max()) if bool(live.any()) else 0.0
      if not worst <= 1e-4 or not bool(live.any()):
        raise AssertionError(f"{name}: fp32 deepest contact {worst:.3e} "
                             "from fp64")
      rows.append(f"{name} {int(live.sum())} of 64 in contact, {worst:.3e}")
    add(read_launches(linalg))
    log(phase, "fp32 deepest SDF contact of 64 states against fp64 (tol "
        "1e-4): " + "; ".join(rows))

    # the touch grid in fp32 against fp64: each channel's sum, each
    # contact's taxel away from the bin edges
    m32 = suite_model(mt, "plugin_touch_grid", dev, torch.float32)
    m64 = suite_model(mt, "plugin_touch_grid", dev, torch.float64)
    d64 = plugin_data(mt, m64, "plugin_touch_grid", 64, seed=30)
    d32 = mt.make_data(m32, 64).replace(qpos=d64.qpos.float(),
                                        qvel=d64.qvel.float())
    reset_launches(linalg)
    f32, f64 = mt.forward(m32, d32), mt.forward(m64, d64)
    add(read_launches(linalg))
    inst = m64.plugin_hooks[0]
    nch = inst.nchannel
    sums = lambda f: f.sensordata.double().reshape(64, nch, -1).sum(-1)
    s32, s64 = sums(f32), sums(f64)
    scale = s64.abs().amax(0)
    worst = ((s32 - s64).abs().amax(0) / scale.clamp(min=1e-300))
    _, tax32, val32, _, _ = m32.plugin_hooks[0].contacts(m32, f32, 0)
    _, tax64, val64, az, el = inst.contacts(m64, f64, 0)
    edge = lambda a, e: (a[..., None] - torch.as_tensor(
        e, device=dev)).abs().amin(-1)
    clear = (edge(az, inst.x_edges) > 1e-5) & (edge(el, inst.y_edges) > 1e-5)
    same = (val32 == val64) & (~val64 | (tax32 == tax64))
    if not bool((worst <= 1e-4).all()) or not bool(same[clear].all()):
      raise AssertionError(f"touch grid fp32 vs fp64: channel sums "
                           f"{worst.tolist()} of their scales, "
                           f"{int((~same & clear).sum())} contacts binned "
                           "apart")
    log(phase, f"touch grid fp32 against fp64, 64 states: each channel's "
        f"taxel sum within {float(worst.max()):.3e} of its scale "
        f"{[round(float(x), 4) for x in scale]} (tol 1e-4); "
        f"{int((val64 & clear).sum())} contacts counted and clear of the bin "
        f"edges by 1e-5 rad, each in the same taxel, "
        f"{int((val64 & ~clear).sum())} within 1e-5 rad of an edge")

    # the fork's inverse_test: the ball in the bowl under RK4; the cable
    # (10 g segments: forces of 1e-3 randn) under its own EULER, as RK4
    # diverges on it from rest within 0.004 s, in C as well (its elastic
    # stiffness over these inertias)
    for name, integrator, scale in (("plugin_cable", "EULER", 1e-3),
                                    ("sdf_bowl", "RK4", 0.05)):
      m = suite_model(mt, name, dev, torch.float64, integrator=integrator)
      add(box_inverse_test(
          mt, linalg, dev, m, phase, name, PLUGIN_INVERSE_STEPS, seed=31,
          data=lambda mt, m, b, seed, name=name: plugin_data(
              mt, m, name, b, seed), scale=scale))

    # transition_ad of 8 lanes of the sphere resting on the torus
    m = suite_model(mt, "sdf_torus", dev, torch.float64)
    d = mt.forward(m, plugin_data(mt, m, "sdf_torus", 8, seed=32))
    reset_launches(linalg)
    t0 = time.perf_counter()
    ad = derivative.transition_ad(m, d)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    if not all(launches.values()):
      raise AssertionError(f"a kernel was not launched: {launches}")
    add(launches)
    with plain_cholesky(linalg):
      plain = derivative.transition_ad(m, d)
    fd = derivative.transition_fd(
        m, d.replace(qacc_warmstart=torch.zeros_like(d.qacc_warmstart)),
        eps=1e-6, flg_centered=True)
    err_plain = float((ad.A - plain.A).abs().max())
    err_fd = float((ad.A - fd.A).abs().max())
    scale = float(fd.A.abs().max())
    ncon = int((d.contact.dist < d.contact.includemargin).sum())
    if not err_plain <= 1e-9:
      raise AssertionError(f"transition_ad kernels vs plain: {err_plain:.3e}")
    if not err_fd <= 1e-4 * scale:
      raise AssertionError(f"transition_ad vs transition_fd: {err_fd:.3e} of "
                           f"max|A| {scale:.3e}")
    log(phase,
        f"sdf_torus 8 lanes fp64, the sphere resting, {ncon} active "
        f"contacts: transition_ad {seconds:.3f} s, A {tuple(ad.A.shape)}; "
        f"kernels vs plain max |dA| {err_plain:.3e} (tol 1e-9); vs "
        f"transition_fd (centered, eps 1e-6) max |dA| {err_fd:.3e} = "
        f"{err_fd / scale:.3e} of max|A| {scale:.3e} (tol 1e-4 of it); "
        f"launches {launches}, tangents a lane {read_tangents(linalg)}")
  log(phase, f"phase 27 in {time.perf_counter() - t_phase:.1f} s")
  return total, times


def sysid_problem(mt, m, lanes: int, seed: int, index=None):
  """Phase 28's system identification on the humanoid ``m``: phase 6's
  fleet states raised SYSID_RAISE m off the floor (``fleet_data``), hidden
  controls u* uniform over the middle 80% of each ctrlrange, and the
  residual r(u) = (qvel after one ``step`` under u - qvel under u*) / h
  (the qvel difference over the timestep, so that box_qp's absolute 1e-16
  improvement floor lies below the fit's tolerance).  ``index`` keeps
  those lanes of the fleet.  Returns (the residual, u*, lower, upper, the
  lanes' states under u*)."""
  from mujoco_inversedynamicstest_tpu_torch.utils import tree

  d = fleet_data(mt, m, lanes, seed=seed, drop=-SYSID_RAISE)
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  rng = np.random.RandomState(seed)
  frac = torch.as_tensor(0.1 + 0.8 * rng.rand(lanes, m.nu), dtype=m.dtype,
                         device=m.device)
  u_star = lo + (hi - lo) * frac
  if index is not None:
    d = tree.map_leaves(d, lambda _, x: x[index])
    u_star = u_star[index]
  at_star = mt.step(m, d.replace(ctrl=u_star))
  target = at_star.qvel
  h = m.opt.timestep

  def residual(u):
    return (mt.step(m, d.replace(ctrl=u)).qvel - target) / h

  return residual, u_star, lo, hi, at_star


def tools_mpc_config(northstar):
  """Phase 28's humanoid MPC: F = TOOLS_MPC_FLEET, H = TOOLS_MPC_HORIZON,
  one replan, one iLQR iteration, 4 step sizes, every timestep linearized
  in one chunk."""
  return northstar.NorthStarConfig(
      horizon=TOOLS_MPC_HORIZON, fleet=TOOLS_MPC_FLEET, n_replan=1,
      ilqr_iterations=1,
      n_alpha=4, lin_batch=None)


def tools_shapes(mt) -> tuple[set, set]:
  """Phase 28's launches, as ``constraint_shapes`` counts them, at n = 27
  (the humanoid has one tree): the fp32 system identification's fleet
  (SYSID_LANES: the step of each iteration, its dual step's primal, JVPs
  at nu = 21 tangents) and the fp64 one's (the fleet's step under u*, then
  8 lanes); the MPC at F =
  TOOLS_MPC_FLEET (the first rollout's F lanes, the forward pass's F x 4
  step sizes, the linearization's F H lanes with their 75 tangents); the
  sharded step at the fleet's 4096 lanes."""
  f, hor = TOOLS_MPC_FLEET, TOOLS_MPC_HORIZON
  primal = {(27, b, torch.float32) for b in (SYSID_LANES, f, 4 * f, f * hor,
                                             FLEET)}
  primal |= {(27, 8, torch.float64), (27, SYSID_LANES, torch.float64)}
  jvp = {(27, SYSID_LANES, 21, torch.float32), (27, 8, 21, torch.float64),
         (27, f * hor, 75, torch.float32)}
  return primal, jvp


@contextlib.contextmanager
def deterministic():
  """torch's deterministic algorithms, as a bit-equality check needs them
  (cuBLAS reads CUBLAS_WORKSPACE_CONFIG, which ``main`` sets for the
  processes that run these checks)."""
  torch.use_deterministic_algorithms(True)
  try:
    yield
  finally:
    torch.use_deterministic_algorithms(False)


def tools_slice(mt, linalg, dev, card: str) -> tuple[dict, dict]:
  """Phase 28: the tools around the engine on the humanoid
  (``assets/humanoid.npz``: nv 27, nu 21, Newton).  Timed: system
  identification by ``opt.least_squares`` (SYSID_LANES fp32 lanes, bounded
  by ctrlrange from u = 0, SYSID_ITERS iterations at most): lanes within
  1e-3 of the range of u*, finite lanes, iterations, seconds, launches; the
  kernels at its shapes; ``mpc_weak_scaling``'s point on the cards
  present.  Checks (under torch's deterministic algorithms): the fp64 fit
  of 8 lanes without a constraint row within 1e-8 of the range of u*, the
  kernels against the plain versions; a fleet MPC checkpointed after one
  cycle, restored onto the card and resumed, bit-equal to two cycles; the
  sharded fleet step of 4096 lanes and the sharded fleet MPC bit-equal to
  the unsharded ones; names and a keyframe from the snapshots on CUDA
  tensors; a printer dump of the model and one lane under chiprun_out/;
  the band solvers at (B, ntotal, nband) = BAND against the dense fp64
  factor.  Returns the kernels' launches and the timings."""
  from mujoco_inversedynamicstest_tpu_torch.opt import derivative, northstar
  from mujoco_inversedynamicstest_tpu_torch.opt import mpc as mpc_mod
  from mujoco_inversedynamicstest_tpu_torch.parallel import scaling, sharding
  from mujoco_inversedynamicstest_tpu_torch.utils import checkpoint, printer
  from mujoco_inversedynamicstest_tpu_torch.utils import tree

  t_phase = time.perf_counter()
  phase = "slice: tools"
  total = dict.fromkeys(KERNELS, 0)
  times = {}

  def add(launches):
    for k in KERNELS:
      total[k] += launches[k]

  if TIMED:
    m = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                     dtype=torch.float32)
    residual, u_star, lo, hi, at_star = sysid_problem(mt, m, SYSID_LANES,
                                                      seed=28)
    u0 = torch.zeros_like(u_star)
    torch.cuda.synchronize()
    reset_launches(linalg)
    t0 = time.perf_counter()
    res = mt.opt.least_squares(residual, u0, bounds=(lo, hi),
                               max_iter=SYSID_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(linalg)
    add(launches)
    err = ((res.x - u_star).abs() / (hi - lo)).amax(1)
    finite = torch.isfinite(res.x).all(1)
    rows = at_star.efc_active.any(1) if at_star.efc_active is not None else (
        torch.zeros_like(finite))
    near = err <= 1e-3
    log(phase,
        f"system identification, humanoid B={SYSID_LANES} fp32 (nu 21 "
        f"controls from 27 qvel, bounded, <= {SYSID_ITERS} iterations) in "
        f"{seconds:.3f} s on {card}: lanes within 1e-3 of the range of u* "
        f"{int(near.sum())} of {SYSID_LANES} ({int((near & ~rows).sum())} of "
        f"the {int((~rows).sum())} without an active constraint row under "
        f"u*); finite lanes {int(finite.sum())}; iterations mean "
        f"{float(res.niter.double().mean()):.2f}, max {int(res.niter.max())};"
        f" median |u - u*| / range {float(err.median()):.3e}; launches "
        f"{launches}, tangents a lane {read_tangents(linalg)}")
    if not bool(finite.all()):
      raise AssertionError(f"{int((~finite).sum())} non-finite fits")
    # a control moves neither M nor the Newton Hessian (each a function of
    # the position and the active rows): the factor's tangent is zero and
    # only the MPC below launches its JVP kernel
    if not all(v for k, v in launches.items() if k != "chol_factor_jvp"):
      raise AssertionError(f"a kernel was not launched: {launches}")
    for k, v in time_kernels(linalg, dev, 27, SYSID_LANES).items():
      times.setdefault(k, {}).setdefault("by_shape", {})[
          f"({SYSID_LANES}, 27) fp32, phase 28"] = v
    for k, v in time_jvp_kernels(linalg, dev, 27, SYSID_LANES, 21,
                                 torch.float32).items():
      times.setdefault(k, {}).setdefault("by_shape", {})[
          f"(27, {SYSID_LANES} lanes, 21 tangents) fp32, phase 28"] = v

    cfg = tools_mpc_config(northstar)
    mesh = sharding.make_mesh()
    reset_launches(linalg)
    point = scaling.mpc_weak_scaling(
        m, northstar.balance_cost(m), mt.make_data(m, 1), cfg,
        fleet_per_device=TOOLS_MPC_FLEET)
    launches = read_launches(linalg)
    add(launches)
    if not all(total.values()):
      raise AssertionError(f"a kernel was not launched: {total}")
    p = point.points[0]
    log(phase,
        f"mpc_weak_scaling on {mesh.size} card(s) ({card}), humanoid fp32, "
        f"{TOOLS_MPC_FLEET} lanes a card, H = {TOOLS_MPC_HORIZON}, one "
        f"iteration: points {[q.n_devices for q in point.points]}; "
        f"{p.solves_per_sec:.3f} solves/s, warm run {p.wall_time_s:.3f} s, "
        f"cold run {p.compile_time_s:.3f} s, plan cost mean "
        f"{p.plan_cost_mean:.4f}; efficiency "
        + ("not measurable on one card" if len(point.points) == 1 else
           f"{point.efficiency:.4f}") + f"; launches {launches}")
    if not np.isfinite(p.plan_cost_mean):
      raise AssertionError("weak scaling: non-finite plan cost")

  if CHECKS:
    with deterministic():
      # the fp64 fit of 8 lanes with no active constraint row under u*
      m = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                       dtype=torch.float64)
      at_star = sysid_problem(mt, m, SYSID_LANES, seed=28)[-1]
      free = torch.nonzero(~at_star.efc_active.any(1))[:8, 0]
      if len(free) < 8:
        raise AssertionError(f"only {len(free)} lanes without a row")
      res8, u_star8, lo, hi, _ = sysid_problem(mt, m, SYSID_LANES, seed=28,
                                               index=free)
      reset_launches(linalg)
      fit = mt.opt.least_squares(res8, torch.zeros_like(u_star8),
                                 bounds=(lo, hi), max_iter=SYSID_ITERS)
      launches = read_launches(linalg)
      add(launches)
      with plain_cholesky(linalg):
        plain = mt.opt.least_squares(res8, torch.zeros_like(u_star8),
                                     bounds=(lo, hi), max_iter=SYSID_ITERS)
      err = float(((fit.x - u_star8).abs() / (hi - lo)).max())
      vs_plain = float((fit.x - plain.x).abs().max())
      log(phase,
          f"system identification, 8 lanes fp64 (lanes {free.tolist()} of "
          f"the fleet: no active row under u*): max |u - u*| / range "
          f"{err:.3e} (tol 1e-8), iterations {fit.niter.tolist()}; kernels "
          f"vs plain max |dx| {vs_plain:.3e} (tol 1e-12); launches "
          f"{launches}")
      if not err <= 1e-8 or not vs_plain <= 1e-12:
        raise AssertionError(f"fp64 system identification: {err:.3e} of "
                             f"the range, {vs_plain:.3e} from plain")

      # checkpoint and resume of a fleet MPC, fp32
      m = mt.put_model(mt.asset_path("humanoid.npz"), device=dev,
                       dtype=torch.float32)
      cfg = tools_mpc_config(northstar)
      mcfg = cfg.mpc_config()
      cost = northstar.balance_cost(m)
      fleet = northstar.make_fleet(m, mt.make_data(m, 1), cfg)
      warm = mpc_mod.make_warm_start(m, cfg.horizon, cfg.fleet)
      cycle = lambda mm, c: mpc_mod.mpc_step(mm, cost, c, mcfg).carry
      reset_launches(linalg)
      mid = cycle(m, mpc_mod.MPCCarry(d=fleet, us_warm=warm))
      ref = cycle(m, mid)
      path = os.path.join(REPO, "chiprun_out", "tools_checkpoint")
      checkpoint.save(path, m, mid)
      m2 = checkpoint.load_model(path, device=dev)
      template = mpc_mod.MPCCarry(
          d=derivative.select_lanes(mt.make_data(m2, cfg.fleet), slice(None)),
          us_warm=torch.zeros_like(warm))
      restored = checkpoint.restore(path, template)
      on_card = all(x.device.type == torch.device(dev).type
                    for _, x in tree.leaves_with_path(restored))
      resumed = cycle(m2, restored)
      add(read_launches(linalg))
      same = all(torch.equal(a, b) for a, b in (
          (resumed.d.qpos, ref.d.qpos), (resumed.d.qvel, ref.d.qvel),
          (resumed.us_warm, ref.us_warm)))
      size = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
      log(phase,
          f"checkpoint: humanoid MPC F={cfg.fleet} fp32 H={cfg.horizon}, "
          f"one cycle, saved ({size} bytes), restored onto {card} (every "
          f"leaf on the card: {on_card}), resumed: qpos, qvel and the warm "
          f"plan bit-equal to two uninterrupted cycles: {same}")
      if not same or not on_card:
        raise AssertionError("the resumed MPC differs from the "
                             "uninterrupted one")

      # the sharded fleet step and fleet MPC against the unsharded ones
      mesh = sharding.make_mesh()
      d = fleet_data(mt, m, FLEET, seed=0)
      reset_launches(linalg)
      whole = mt.step(m, d)
      out, gmean = sharding.sharded_step_fn(m, mesh, mt.step)(
          sharding.shard_batch(mesh, d))
      out = out.gather()
      step_same = all(torch.equal(getattr(out, f), getattr(whole, f))
                      for f in ("qpos", "qvel", "qacc", "act"))
      mean_err = float((gmean - whole.qacc.abs().mean()).abs())
      ref_run = northstar.fleet_mpc_fn(m, cost, cfg)(fleet)
      costs, cmean = scaling.sharded_fleet_mpc_fn(m, cost, cfg, mesh)(
          sharding.shard_batch(mesh, fleet))
      add(read_launches(linalg))
      mpc_same = torch.equal(costs, ref_run.plan_costs)
      log(phase,
          f"sharding over {mesh.size} card(s): the fleet step of {FLEET} "
          f"lanes fp32 bit-equal to the unsharded step: {step_same}, "
          f"pmean |qacc| {float(gmean):.6g} ({mean_err:.3e} from the "
          f"unsharded mean); the fleet MPC (F={cfg.fleet}) plan costs "
          f"bit-equal to fleet_mpc_fn's: {mpc_same} (mean {float(cmean):.6g})")
      if not step_same or not mpc_same or not mean_err <= 1e-5 * float(
          whole.qacc.abs().mean()):
        raise AssertionError("the sharded runs differ from the unsharded")

    # names and a keyframe from the snapshots, on CUDA tensors
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import balance  # noqa: PLC0415  (C's joint and body names of the humanoid)

    joints = tuple(mt.id2name(m, "joint", i) or "" for i in range(m.njnt))
    bodies = tuple(mt.id2name(m, "body", i) or "" for i in range(m.nbody))
    ids_ok = all(mt.name2id(m, "joint", n) == i
                 for i, n in enumerate(joints) if n)
    mk = mt.put_model(mt.asset_path("keyframes.npz"), device=dev,
                      dtype=torch.float64)
    with np.load(mt.asset_path("keyframes.npz")) as z:
      snap = {k: z[k] for k in z.files}
    k = mt.name2id(mk, "key", "home")
    lanes = torch.tensor([True, False, True, False], device=dev)
    dk = mt.reset_data_keyframe(mk, mt.make_data(mk, 4), "home", lanes=lanes)
    key_ok = all(
        torch.equal(getattr(dk, f)[lanes].cpu(), torch.as_tensor(
            snap[key][k].reshape(getattr(dk, f).shape[1:])).expand(2, *getattr(
                dk, f).shape[1:]))
        for f, key in (("qpos", "key_qpos"), ("qvel", "key_qvel"),
                       ("act", "key_act"), ("ctrl", "key_ctrl"),
                       ("mocap_pos", "key_mpos"), ("mocap_quat", "key_mquat")))
    log(phase,
        f"names from humanoid.npz on {card}: joints and bodies equal C's "
        f"tables (scripts/balance.py): {joints == balance.JOINTS and bodies == balance.BODIES}"
        f", name2id inverts id2name: {ids_ok}; keyframe 'home' (id {k}) of "
        f"keyframes.npz reset on lanes 0 and 2 of 4, bit-equal to the "
        f"snapshot's rows: {key_ok}")
    if not (joints == balance.JOINTS and bodies == balance.BODIES and ids_ok
            and key_ok and dk.qpos.device.type == torch.device(dev).type):
      raise AssertionError("names or keyframes differ from the snapshot's")

    # a printer dump of the model on the card and one lane
    dump = os.path.join(REPO, "chiprun_out", "tools_dump.txt")
    lane = tree.map_leaves(mt.forward(m, fleet), lambda _, x: x[:1])
    with open(dump, "w") as f:
      f.write(printer.format_pytree(m, "model") + printer.format_pytree(
          lane, "data"))
    text = open(dump).read()
    fields_ok = all(f"  {f}  " in text for f in ("qpos0", "geom_size", "qpos",
                                                 "qacc", "qM", "xpos"))
    log(phase, f"printer: the model and one lane on {card} dumped to "
        f"{os.path.relpath(dump, REPO)} ({len(text)} bytes, "
        f"{text.count(chr(10))} lines); load-bearing fields present: "
        f"{fields_ok}")
    if not fields_ok:
      raise AssertionError("the printer dump lacks a field")

    # the band solvers against the dense fp64 factor
    b, ntotal, nband = BAND
    rng = np.random.RandomState(28)
    g = torch.as_tensor(rng.randn(b, ntotal, ntotal), device=dev)
    dense = g @ g.transpose(1, 2)
    idx = torch.arange(ntotal, device=dev)
    mask = (idx[:, None] - idx[None, :]).abs() < nband
    dense = dense * mask + ntotal * torch.eye(ntotal, device=dev,
                                              dtype=dense.dtype)
    rhs = torch.as_tensor(rng.randn(b, ntotal), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_band = mt.opt.chol_factor_band(mt.opt.dense_to_band(dense, nband))
    x = mt.opt.chol_solve_band(l_band, rhs)
    torch.cuda.synchronize()
    band_s = time.perf_counter() - t0
    l_dense = torch.linalg.cholesky(dense)
    err_l = float((mt.opt.band_to_dense(l_band, lower_only=True)
                   - l_dense).abs().max())
    err_x = float((x - torch.linalg.solve(dense, rhs)).abs().max())
    log(phase,
        f"band solvers at (B, ntotal, nband) = {BAND} fp64 on {card}: factor "
        f"and solve {band_s:.3f} s; max |L - cholesky(dense)| {err_l:.3e}, "
        f"max |x - solve(dense)| {err_x:.3e} (tol 1e-9)")
    if not err_l <= 1e-9 or not err_x <= 1e-9:
      raise AssertionError("band solvers differ from the dense factor")
  log(phase, f"phase 28 in {time.perf_counter() - t_phase:.1f} s")
  return total, times


def fleet_rate(mt, dev) -> float:
  """Phase 6's timed loop alone (100 steps of 4096 humanoid_mjx lanes,
  fp32, after a warm-up step): steps/s."""
  m = mt.put_model(mt.asset_path("humanoid_mjx.npz"), device=dev,
                   dtype=torch.float32)
  d = mt.step(m, fleet_data(mt, m, FLEET, seed=0))
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(FLEET_STEPS):
    d = mt.step(m, d)
  torch.cuda.synchronize()
  return FLEET * FLEET_STEPS / (time.perf_counter() - t0)


class ChecksProcess:
  """The untimed fp64 checks (``--checks``) in a second process on the same
  card: its lines are printed as they
  come, after ``checks |``, and its last line is its result.  ``result``
  waits for it and fails the run unless it exited with 0; ``stop`` ends it
  whatever its state."""

  def __init__(self):
    self.lines = []
    self.proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--checks"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    self.reader = threading.Thread(target=self._read, daemon=True)
    self.reader.start()

  def _read(self):
    for line in self.proc.stdout:
      self.lines.append(line.rstrip("\n"))
      print(f"checks | {self.lines[-1]}", flush=True)

  def result(self) -> dict:
    rc = self.proc.wait()
    self.reader.join()
    if rc != 0:
      raise SystemExit(f"chip_smoke: the checks process failed ({rc})")
    return json.loads(self.lines[-1])["checks"]

  def stop(self):
    if self.proc.poll() is None:
      self.proc.kill()
      self.proc.wait()


def run_checks(mt, linalg, dev, smi, lap) -> None:
  """The checks process: the kernels against their plain versions (phases
  3-4, 8, 9), phases 7, 10 and 16, and the fp64 checks of phases 6, 13, 15
  and 17-28.  Prints one JSON line: its launches by path, the kernels'
  largest errors, and the launches at shapes phase 9 did not check."""
  slice_err = check_kernels(linalg, dev)
  slice_err.update(check_jvp_kernels(linalg, dev))
  lap("3-4, 8")
  check_path_kernels(mt, linalg, dev)
  main_path_shapes(linalg)
  lap("9")
  by_path = {"fleet_step": fleet_step(mt, linalg, dev, smi)}
  lap("6")
  inverse_dynamics(mt, linalg, dev)
  lap("7")
  for asset in ("humanoid.npz", "humanoid_mjx.npz"):
    transition(mt, linalg, dev, asset)
  for integrator in ("RK4", "IMPLICIT"):
    transition(mt, linalg, dev, "humanoid.npz", integrator)
  lap("10")
  mpc_reference(mt, linalg, dev)
  lap("13")
  by_path["integrators_fleet"] = integrators_fleet(mt, linalg, dev, smi)
  lap("15")
  by_path["inverse_test"] = inverse_test(mt, linalg, dev)
  lap("16")
  by_path["sensors"] = sensors(mt, linalg, dev, smi)
  lap("17")
  by_path["constraint_rows"] = constraint_rows(mt, linalg, dev, smi)[0]
  lap("18")
  by_path["tendons"] = tendon_slice(mt, linalg, dev, smi)[0]
  lap("19")
  by_path["convex"] = convex_slice(mt, linalg, dev, smi)[0]
  lap("20")
  by_path["contact"] = contact_slice(mt, linalg, dev, smi)[0]
  lap("22")
  by_path["shapes"] = quadruped_slice(mt, linalg, dev, smi)[0]
  lap("23")
  by_path["suite"] = suite_slice(mt, linalg, dev, smi)[0]
  lap("24")
  by_path["flex"] = flex_slice(mt, linalg, dev, smi)[0]
  lap("25")
  by_path["tail"] = tail_slice(mt, linalg, dev, smi)[0]
  lap("26")
  by_path["plugins"] = plugin_slice(mt, linalg, dev, smi)[0]
  lap("27")
  by_path["tools"] = tools_slice(mt, linalg, dev, smi)[0]
  lap("28")
  print(json.dumps({"checks": {"by_path": by_path, "slice_err": slice_err,
                               "unchecked": unchecked_shapes(mt, linalg)}}))


def main() -> None:
  global TIMED, CHECKS
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  mode = parser.add_mutually_exclusive_group()
  mode.add_argument("--bench", action="store_true",
                    help="only the MPC fleet at the bench configuration, "
                    "each humanoid, with a solve timed by iLQR stage")
  mode.add_argument("--fleet", action="store_true",
                    help="only the fleet step, to compare two checkouts")
  mode.add_argument("--convex", action="store_true",
                    help="only phase 20, the boxes and convex meshes")
  mode.add_argument("--lqr", action="store_true",
                    help="only phase 21, the humanoid's balance LQR")
  mode.add_argument("--contact", action="store_true",
                    help="only phase 22, the contact models")
  mode.add_argument("--shapes", action="store_true",
                    help="only phase 23, the quadruped and the terrain")
  mode.add_argument("--suite", action="store_true",
                    help="only phase 24, the solvers, fluid and energy")
  mode.add_argument("--flex", action="store_true",
                    help="only phase 25, the flex scenes")
  mode.add_argument("--tail", action="store_true",
                    help="only phase 26, the sensor tail and the "
                    "transmissions")
  mode.add_argument("--plugins", action="store_true",
                    help="only phase 27, the engine plugins and the SDF "
                    "plugin geoms")
  mode.add_argument("--tools", action="store_true",
                    help="only phase 28, least squares, checkpoints, "
                    "sharding, names, the printer and the band solvers")
  mode.add_argument("--checks", action="store_true",
                    help="the untimed checks of a full run (the full run "
                    "starts this process itself)")
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
  sys.path.insert(0, REPO)
  import mujoco_inversedynamicstest_tpu_torch as mt
  from mujoco_inversedynamicstest_tpu_torch.ops import linalg

  if args.checks or args.tools:
    # cuBLAS's deterministic form, which phase 28's bit-equality checks
    # run under (read when the process makes its first cuBLAS handle)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
  if not args.checks:
    tee_log(os.path.join(REPO, "chiprun_out", "chip_smoke.log"))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda:0")
  smi = nvidia_smi()
  log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
      f"cuda {torch.version.cuda} | {smi} | TF32 off")

  t0 = time.perf_counter()
  path, nvcc_log = linalg.build_kernels()
  build_s = time.perf_counter() - t0
  regs = [ln.split(":", 1)[1].strip() for ln in nvcc_log.splitlines()
          if "registers" in ln]
  log("build", f"nvcc sm_90a {SOURCE} -> {os.path.relpath(path, REPO)} in "
      f"{build_s:.2f} s; ptxas: {' | '.join(regs)}")
  t_last = [t0]

  def lap(phases: str) -> None:
    now = time.perf_counter()
    log("time", f"phases {phases} in {now - t_last[0]:.1f} s, "
        f"{now - t0:.1f} s since the build began")
    t_last[0] = now

  if args.checks:
    TIMED = False
    run_checks(mt, linalg, dev, smi, lap)
    return
  if args.bench:
    for asset in ("humanoid_mjx.npz", "humanoid.npz"):
      mpc_fleet(mt, linalg, dev, asset, MPC_BENCH, profile_run=True)
  elif args.fleet:
    fleet_step(mt, linalg, dev, smi)
  elif args.convex:
    convex_slice(mt, linalg, dev, smi)
  elif args.lqr:
    balance_slice(mt, linalg, dev, smi)
  elif args.contact:
    contact_slice(mt, linalg, dev, smi)
  elif args.shapes:
    quadruped_slice(mt, linalg, dev, smi)
  elif args.suite or args.flex or args.tail or args.plugins or args.tools:
    (suite_slice if args.suite else flex_slice if args.flex else tail_slice
     if args.tail else plugin_slice if args.plugins else tools_slice)(
         mt, linalg, dev, smi)
    unchecked = unchecked_shapes(mt, linalg)
    if unchecked:
      raise AssertionError(f"launches at shapes {unchecked} that phase 9 "
                           "did not hold to the plain versions")
  else:
    CHECKS = False
    rates, checks = [], []
    try:
      by_path, times, tangents = timed_run(mt, linalg, dev, smi, lap, rates,
                                           checks)
      result = checks[0].result()
      lap("(the checks process's end)")
    finally:
      for proc in checks:
        proc.stop()
    rates.append(fleet_rate(mt, dev))
    log("slice: fleet step",
        "steps/s of phase 6's loop, in turns: alone "
        f"{rates[0]:.1f}, with the checks process {rates[1]:.1f}, with it "
        f"{rates[2]:.1f}, alone {rates[3]:.1f} (with / alone "
        f"{(rates[1] + rates[2]) / (rates[0] + rates[3]):.3f})")
    for path_name, counts in result["by_path"].items():
      mine = by_path.setdefault(path_name, {})
      for k, v in counts.items():
        mine[k] = mine.get(k, 0) + v
    launches = {k: sum(p.get(k, 0) for p in by_path.values())
                for k in KERNELS}
    unchecked = sorted(set(unchecked_shapes(mt, linalg))
                       | set(result["unchecked"]))
    if unchecked:
      raise AssertionError(f"launches at shapes {unchecked} that phase 9 "
                           "did not hold to the plain versions")
    for k in KERNELS:
      if not launches[k]:
        raise AssertionError(f"{k} was not launched on the main paths")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "launches_by_path": {p: c[k] for p, c in by_path.items() if k in c},
         "tangents": tangents.get(k),
         "max_abs_err": result["slice_err"][k],
         **times[k]} for k in KERNELS]}))
  print(smi)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


def timed_run(mt, linalg, dev, smi, lap, rates,
              checks) -> tuple[dict, dict, dict]:
  """The timed process of a full run: the kernels' timings (phases 5, 9),
  the fleets, the MPC solves and phases 11, 14 and 21.  Phases 5, 6, 9, 11
  and 12 run alone; then the checks process starts (appended to
  ``checks``) and runs beside the rest: beside phase 12, its own MPC
  solves of phase 13 doubled phase 12's time (194.1 against 395.6 s in two
  runs).  Phase 6's loop is timed alone first and twice once the checks
  process has started (appended to ``rates``).  Returns the launches by
  path, the kernels' timings and the JVP kernels' tangents a lane of
  phase 12."""
  rates.append(fleet_rate(mt, dev))
  by_path = {"fleet_step": fleet_step(mt, linalg, dev, smi)}
  lap("6")
  times = time_kernels(linalg, dev)
  times.update(check_path_kernels(mt, linalg, dev))
  lap("5, 9 (timings)")
  linearization_chunk(mt, linalg, dev)
  lap("11")
  mpc_launches, res, cfg = mpc_fleet(mt, linalg, dev, "humanoid_mjx.npz",
                                     MPC_RUN)
  by_path["mpc_fleet"] = mpc_launches
  tangents = read_tangents(linalg)
  lap("12")
  checks.append(ChecksProcess())
  rates.append(fleet_rate(mt, dev))
  rates.append(fleet_rate(mt, dev))
  lap("(phase 6's loop twice beside the checks process)")
  mpc_reference(mt, linalg, dev)
  lap("13")
  mpc_torques(mt, linalg, dev, res, cfg)
  lap("14")
  by_path["integrators_fleet"] = integrators_fleet(mt, linalg, dev, smi)
  lap("15")
  by_path["sensors"] = sensors(mt, linalg, dev, smi)
  lap("17")
  by_path["constraint_rows"], times_small = constraint_rows(
      mt, linalg, dev, smi)
  lap("18")
  by_path["tendons"], times_n2 = tendon_slice(mt, linalg, dev, smi)
  lap("19")
  by_path["convex"], times_convex = convex_slice(mt, linalg, dev, smi)
  lap("20")
  by_path["lqr_balance"] = balance_slice(mt, linalg, dev, smi)
  lap("21")
  by_path["contact"], times_contact = contact_slice(mt, linalg, dev, smi)
  lap("22")
  by_path["shapes"], times_shapes = quadruped_slice(mt, linalg, dev, smi)
  lap("23")
  by_path["suite"], times_suite = suite_slice(mt, linalg, dev, smi)
  lap("24")
  by_path["flex"], times_flex = flex_slice(mt, linalg, dev, smi)
  lap("25")
  by_path["tail"], times_tail = tail_slice(mt, linalg, dev, smi)
  lap("26")
  by_path["plugins"], times_plugins = plugin_slice(mt, linalg, dev, smi)
  lap("27")
  by_path["tools"], times_tools = tools_slice(mt, linalg, dev, smi)
  lap("28")
  for more in (times_n2, times_convex, times_contact, times_shapes,
               times_suite, times_flex, times_tail, times_plugins,
               times_tools):
    for k, v in more.items():
      for by, rows in v.items():
        times_small.setdefault(k, {}).setdefault(by, {}).update(rows)
  for k, v in times_small.items():
    times[k].update(v)
  return by_path, times, tangents


if __name__ == "__main__":
  main()
