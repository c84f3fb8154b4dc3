#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its seconds; the run fails rather than overrun):
1. device: require CUDA, print the card's name and power limit;
2. build: compile both fused physics kernels (csrc/physics_step.cu: B1 flat,
   B2 heightfield; one warp per env, working set in shared memory) with one
   nvcc call and print ptxas's report of each (registers, stack, spills);
3. B1 against its plain version (physics/aba.py) on the card, a block's
   shared memory printed: one control step from seeded near-standing states
   with random actions at every batch the MPC path launches it with (8 x 128,
   8 x 97, 8 x 3 and 8 envs; 128, 97 and 3 at E=1), at 2048 and at 4096 (the
   training fleet), at 64 (the flat estimator evidence) and 256 (the
   distillation fleet), then 25 control steps of drift at 8 x 97, and two
   launches on the same inputs at 1024 and at 4096, which must agree bit for
   bit;
4. B2 against its plain version on the anymal_c_rough curriculum grid
   (900 x 900 heightfield): near-standing states on the spawn origins, one
   control step at 32 envs (the rough evaluation), 128 (the estimator and
   its closed loop) and 4096 (the rough config's fleet), 25 control steps of
   drift at 32, two launches bit for bit at 4096; B2 and plain timed at
   each batch;
5. MPC path: ANYmal-C flat sampling MPC (RobotTrajGradSampling.mpc_step at
   the committed config, 8 envs, 0.7 m/s command, warm-started from the
   committed checkpoint); B1's launch count is read from this run;
6. rough path: the anymal_c_rough env at 4096 envs, levels frozen, stepped
   20 control steps by the committed rough policy; B2's launch count is read
   from this run and must be 20; then control steps per second, policy
   included, and a short rough evaluation (scripts/eval_rough.run_eval, 32
   envs, 50 + 100 steps, levels <= 2);
7. V-control routes (make_env_step, make_env_step_rough: one substep per
   launch, torques passed in): one substep against plain at 1024 envs on
   flat ground and 4096 on the rough grid, then the V-control envs (the
   flat MPC task's env, the rough evaluation env) stepped V_STEPS control
   steps each; each route's launches are read from its run and must be
   V_STEPS x decimation;
8. training path: flat PPO at the TRAIN_r5 recipe (anymal_c_flat, 4096
   envs, [128, 64, 32] actor and critic, 24 steps per env, seed 2, from
   scratch) through the task registry, OnPolicyRunner.learn for
   TRAIN_ITERS iterations; B1's launches are read from this run and must be
   TRAIN_ITERS x 24 (B2's 0); the loss and every parameter must be finite,
   no update skipped and the parameters changed; the seconds per iteration
   split into collection and update, and env-steps per second; then a
   save, a load into a fresh runner and equal actions from both policies;
9. rough training path: rough PPO at the TRAIN_ROUGH_r5 recipe
   (anymal_c_rough, 4096 envs, [512, 256, 128], seed 1, from scratch, the
   terrain curriculum on) the same way for ROUGH_TRAIN_ITERS iterations;
   B2's launches must be ROUGH_TRAIN_ITERS x 24 (B1's 0), and besides the
   checks of phase 8, some env's terrain level must have changed and every
   level must lie in [0, num_rows);
10. ray path: the anymal_c_rough_raycast env (levels frozen) at 4096 envs
   stepped RAY_STEPS control steps by the committed ray checkpoint; B2's
   launches must be RAY_STEPS; the observation must be 267 wide, its
   32-ray tail finite and in [0, 1], the robots upright; the ray cast's
   time per call at 4096 x 32 rays and the env's control steps per second;
   then a short ray evaluation (128 envs, 50 + 100 steps, levels <= 2,
   0.5 m/s);
11. depth camera: one heightfield render at 4096 envs at the terrain
   estimator's setup (48 x 24 rays resized to 32 x 16), finite and in
   [0, 1] (to float32 rounding of the resize's weights), and its time;
12. estimator path: TerrainEstimatorRunner.learn on the ray task under the
   closed loop's protocol (scripts/estimator_closed_loop.build_env: 128
   envs, levels <= 2) with the committed ray policy driving, EST_ITERS
   iterations; B2's launches must be EST_ITERS x 24 (B1's 0), the loss
   finite and the parameters changed; a save and a load into a fresh runner
   must give equal predictions; the render's time at 128 envs and the
   iteration's; then the committed JAX estimator in an EST_CL_STEPS-step
   closed-loop segment with the ray tail swapped (B2 exactly EST_CL_STEPS):
   finite predictions, robots upright;
13. distillation path: DistillationRunner at the DISTILL_NATIVE_r5 recipe
   (scripts/evidence_artifacts.distill_runner: anymal_c_flat, 256 envs, the
   committed flat teacher) for DISTILL_ITERS iterations; B1's launches must
   be DISTILL_ITERS x 24 (B2's 0), the loss finite, the student's parameters
   changed and the teacher's outputs and parameters unchanged; the
   iteration's time;
14. ElSpider path: B1 with the ElSpider Air hexapod's tables (19 bodies, 18
   joints, 46 spheres, 6 feet) against its plain version run in float64 at
   ELSPIDER_B envs (16 and the fleet's 4096), its ELSPIDER_DRIFT_STEPS-step
   drift at 16 reported three ways (drift_report), two launches bit for bit at 4096;
   ELSPIDER_ITERS iterations of elspider_air_flat training at the fleet (B1
   exactly ELSPIDER_ITERS x 24, the other routes 0) with the save/load round
   trip; the committed JAX checkpoint evaluated (16 envs, 50 + 100 steps,
   0.5 m/s: B1 exactly 150, upright);
15. SEA path: the anymal_c_flat_sea env's torques-in B1 step (EnvStep)
   against plain at the fleet with the actuator network's torques;
   SEA_ITERS training iterations (EnvStep exactly SEA_ITERS x 24 x 4, the
   fused step 0); the committed JAX SEA checkpoint evaluated (16 envs, 50 +
   100 steps, 0.7 m/s, upright);
16. RL extensions on anymal_c_flat at the fleet: a recurrent policy with a
   symmetry_cfg must be refused; EXT_ITERS iterations of the recurrent
   policy (LSTM of 512) with RND, then of the MLP policy with RND and the
   left-right symmetry loss (B1 exactly EXT_ITERS x 24 each, finite losses
   and RND losses, policy and predictor changed); the recurrent inference
   policy must change its action with its carry, give the first action
   again after a reset, and round-trip through a checkpoint;
17. the fixed-base regime (the kernels' TI_FIX flag: zero base
   acceleration, no base solve) with the Franka arm's tables (8 bodies, 7
   joints, one sphere on the base, no feet) against its plain version: one
   control step from states at rest with random actions at FRANKA_B (8, the
   batch rollout's main envs, and 1024, franka_cfg's fleet and 8 x 128
   rollout samples), the base unchanged bit for bit after one step and
   after 25, the 25-step drift at 8 reported (drift_report: the arm's
   2.2-2.6 rad/s limits clamp often), two launches bit for bit at 1024;
18. Franka paths: the franka task through the registry for FRANKA_ITERS
   PPO iterations at 1024 envs (the fixed-base route exactly FRANKA_ITERS x
   24, B1 and B2 0; phase 8's checks), then franka_batch_rollout's
   rollout_batch at 8 main envs x 128 samples x H=16 (exactly 16 launches,
   finite rewards);
19. CyberDog2 on B1: its tables (13 bodies, 12 joints, 37 spheres, 4 feet)
   against the float64 plain version at the walk family's 4096 envs, two
   launches bit for bit; CYBER_ITERS iterations of cyber2_walk training at
   4096 (B1 exactly CYBER_ITERS x 24, phase 8's checks);
20. the LeggedRobot family's kernels: B1 with A1's and Go2's tables, B2
   with A1's, Go2's, ANYmal-B's, Cassie's and the hexapod's, each on its
   own task's grid from the spawn origins, against the float64 plain
   version at 4096 from near-standing states (each block's shared memory
   printed), the FAMILY_DRIFT_STEPS-step drift at 32 reported
   (drift_report), two launches bit for bit at 4096; the fixed-base regime with the hanging hexapod's
   tables (foot_track_elspider_air_hang) from the hang config's initial
   states with random actions (the feet in contact counted, the base
   unchanged bit for bit after 1 and 25 steps) and with its base held at
   0.175 m (legs loaded), each against the float64 plain at 4096, two
   launches bit for bit, and held at 0.17 m, where float32 rounding alone
   moves the plain step by up to ONE_STEP_ATOL, within ONE_STEP_ATOL of the
   float64 plain beyond how far float32 plain steps from inputs moved by
   one ulp lie from it, env by env (track_float32);
21. the family's training paths: FAMILY_ITERS PPO iterations at 4096 envs
   through the registry of a1, go2_rough, anymal_b, cassie,
   elspider_air_rough, anymal_c_rough_teacher and anymal_c_student (the
   critic 235 wide), pose_go2_flat and foot_track_elspider_air_hang (the
   fixed-base route alone): phase 8's checks (CURRICULUM_WAIVED: a1 and
   elspider_air_rough, where no level can move, only when the run shows
   why), the task's route exactly
   FAMILY_ITERS x 24, the others 0; Cassie's termination episode sum finite
   and non-zero where an episode ended (or a line saying none did);
22. the family's other tasks (a1_flat, go2_flat, the ANYmal-C load, pose
   and stand variants, the Go2 load and stand variants, the ElSpider pose
   and flat foot-tracking tasks) through the registry at 4096 envs,
   FAMILY_STEPS control steps each: finite rewards, the route exactly
   FAMILY_STEPS launches, the others 0;
23. confined perception: the arena of elair_barrier_nav (its published 3 x
   3 grid of 6 m subterrains with a 3 m border, the wall-corrected mesh of
   ground and ceiling), raycast_trimesh of CONFINED_RAY_ENVS sensors x 16 x
   8 spherical rays posed over it and query_sdf_trimesh of the nav
   rollout's collision spheres (4 mains x 128 samples), each timed with
   its peak memory and held on CONFINED_CHECK rays / points to the same
   function run in float64 on the CPU (RAY_ATOL, SDF_ATOL; where a ground
   face and a ceiling face coincide, a barrier of zero gap, either normal
   and either sign is right and rounding picks one: such ties are counted,
   as are SDF answers from another face within 1e-4 m of the minimum, see
   check_sdf; every SDF gradient a unit vector; any other difference
   fails);
24. the engine route: one mpc_step of elair_timberpile_nav at its
   published width (4 mains x 128 samples, H = 16, mesh contacts;
   ENGINE_DIFFUSE diffusion step, where the config has 2): no
   kernel launch, EngineEnvStep's substeps exactly the control steps x 4,
   every rollout reward and the main envs' states, observations, rewards
   and plan finite; its time, and the device's idle share over one rollout
   control step;
25. the kernel routes of the new MPC tasks: one mpc_step each of
   anymal_c_percept (B1, 128 spherical rays in its observation) and
   anymal_c_nav_barrier (B2 on the nav config's default rough grid): the
   route's launches exactly one per control step, the others 0;
26. planning: one mpc_step of anymal_c_plan_grad_sampling: no launch and
   no engine substep (kinematic rollouts);
27. the new (regime, tables, batch) pairs at the MPC tasks' rollout batch
   of NAV_B envs against the plain version: B1 on ANYmal-C's and on the
   hexapod's tables (float64 plain), B2 on anymal_c_nav_barrier's grid;
28. the new training paths: NEW_ITERS PPO iterations at the fleet of
   anymal_c_flat_obstacles (B1; the stones fall, and a stone planted in a
   base exchanges force with it) and elspider_air_rough_raycast (B2, 128
   spherical rays cast twice per observation), phase 8's checks, then one
   iteration profiled for the device's idle share;
29. polish modes: one E=1 flagship solve (anymal_c_traj_sampling_cfg:
   Nsample=127, Hsample=16, Hnode=4, Ndiffuse=2) per polish mode, "none",
   "fd", "gradient" and "ilqr", POLISH_ITERS polish iterations each
   (scripts/bench_polish): B1's launches and the plain engine's substeps
   exactly what the solve's structure implies (the engine only for gradient
   and iLQR; fd's B1 count that of the kernel route alone), no env's
   fast-route score lowered by its polish, each solve's ms;
30. gradients on the card: the differentiable route's node gradient at E=1
   over GRAD_HS + 1 steps, and one control step's fx and fu (forward-mode,
   trajopt/riccati._linearize), each held to the float64 plain engine on
   the CPU within GRAD_TOL_FACTOR x the CPU's float32 - float64 gap (plus
   1e-6 of the largest entry), the tolerance printed;
31. the 17 tasks of the last slice through the registry: one mpc_step of
   each sampling-MPC task at its registered main envs (the route's
   launches exactly one per control step: anymal_c_dialmpc_flat and
   elspider_air_dialmpc_flat launch 32 x 128 = 4096 envs), one
   rollout_batch (ROLLOUT_S samples, H=16) and one step of each
   batch-rollout task at its 16 main envs (the route exactly 18 launches;
   the two ElSpider ones register the plain ElSpider env, as the JAX
   package does, which has no rollout_batch: two steps, 2 launches),
   POSE_STEPS steps of each pose-adapt task at its 1024 envs (no launch, no
   engine substep); rewards and observations finite;
32. the new kernel pairs against the float64 plain step, two launches bit
   for bit: B1 on Cassie's tables at 128 (cassie_traj_grad_sampling's
   rollout batch), B1 at B=1 (the iLQR's node scoring), B2 on the hexapod's
   tables at 512 on elspider_air_dialmpc's grid;
33. play: scripts/play on anymal_c_flat from the committed checkpoint
   (logs/flat_anymal_c/Aug21_12-38-39_r5_ft4, the [128, 64, 32] actor)
   into a temporary directory: exactly 500 B1 launches at 50 envs (10 s of
   control steps), the first launch held to the plain step, every
   observation and action finite, play_log.jsonl and play_states.json
   written, the mean |vx - cmd| and ms per control step printed, then the
   device's idle share over 25 profiled control steps;
34. export: runner.export_policy of play's runner; policy_1.pt (TorchScript)
   and policy.pt2 (torch.export) loaded on the card and held to the runner's
   inference policy on 50 observations within 1e-5 (TF32 off); an LSTM
   policy_lstm_1.pt of a freshly made recurrent runner held to
   RecurrentInferencePolicy over 5 steps, a reset_memory() and a step;
35. nccl: init_multi_host at world size 1 on a free local port, one
   all_reduce that returns its input, shard_batch and replicate of a tree on
   the card;
36. data-parallel PPO: (a) anymal_c_flat at the fleet's 4096 envs, one
   iteration through OnPolicyRunner with phase 35's world-size-1 NCCL mesh
   beside one without a mesh from the same state and draws (the empirical
   normalizer on, so that its reduction runs): parameters, normalizer and
   learning rate bit for bit, B1 exactly 24 in the mesh's iteration; (b)
   scripts/dryrun_multichip in 2 processes on the card over gloo: its
   committed-shape training pass (2 x 512 envs, [128, 64, 32], T=24; both
   ranks' parameters, normalizer and learning rate bit for bit, B1 exactly
   24 on each rank) and its toy sample-sharded optimize (within 1e-5 of the
   one-process optimize of the same noise, the ranks bit for bit);
37. weak scaling: scripts/weak_scaling's saturation sweep at 64, 512 and
   4096 samples (E=2, H=16: B1 at 128, 1024 and 8192 envs), B1's launches
   exactly 3 chains x 4 rollouts x 17 steps per size, one launch at 8192
   held to the plain step, then its weak-scaling row at world size 1 in
   phase 35's group (the same launch count), and the group destroyed;
38. command options: anymal_c_flat with commands.heading_command and
   commands.curriculum on at 4096 envs, 24 control steps of the committed
   flat policy: exactly 24 B1 launches, column 2 the P law of column 3 and
   the base heading (zero where an env just reset), everything finite;
39. sim options: anymal_c_flat at OPT_ENVS envs with asset.armature
   OPT_ARMATURE and sim.enforce_dof_vel_limits off: the wrapper's
   velocity-limit and armature rows hold 500 and OPT_ARMATURE, B1 against
   the plain step with the same options from joint velocities of OPT_FAST
   rad/s (past the 20 rad/s limit, which the kernel must leave unclamped),
   then OPT_STEPS control steps of the env with random actions (B1 exactly
   OPT_STEPS, the others 0); the same task at OPT_ENGINE_ENVS envs with
   sim.solver "crba", then "aba": OPT_STEPS control steps each with no
   kernel launch, EngineEnvStep's substeps exactly OPT_STEPS x 4, the state
   finite; then one line naming the sinks the training paths'
   MetricsWriter wrote (the JSONL file always, TensorBoard's event file
   where tensorboard imports);
40. flat evaluation: scripts/eval_policy on the committed JAX checkpoint
   (16 envs, 50 + 100 steps): finite values, upright_mean below -0.9;
41. timing: the MPC solve latency at 1 env (TIMING_SOLVES solves) and the
   rollout throughput at 16
   envs x 128 samples x H=64, timed with CUDA events;
42. the kernel line (JSON) and the result line.  B1's entry counts its
   launches on the MPC path, the flat training path, the distillation path,
   the RL-extension paths and the ANYmal-C variants' stepping; B1's entry
   on the hexapod's tables its launches on the ElSpider path and the
   ElSpider pose and foot-tracking stepping; the SEA route's its launches
   on the SEA training path; B2's entry on the rough path, the ray path,
   the rough training path, the estimator path and the teacher's and the
   student's training; the fixed-base regime's on the Franka training and
   rollout paths, with its times at 1024; B1's entry on CyberDog2's tables
   on the CyberDog2 training path; each family entry (B1 on A1's and Go2's
   tables, B2 on the five new tables, the fixed-base regime on the
   hexapod's) its launches in phases 21-22; B1's entry also counts
   anymal_c_percept's and anymal_c_flat_obstacles' launches (phases 25,
   28), B2's anymal_c_nav_barrier's, the hexapod's B2 entry
   elspider_air_rough_raycast's; phases 29 and 31 add each launch to the
   entry of its tables (B1 on Cassie's a new entry, its times at 128); B1's
   entry also counts phase 36's launches (the mesh's iteration and each
   gloo rank's training and sharded optimize), phase 37's at 128 and 1024
   and its weak-scaling row's, phase 38's and phase 39's; play's launches
   (phase 33) and the sweep's at 8192 (phase 37) are entries of their own, with their times at
   50 and 8192; the others carry their times
   at the training fleet's 4096.  An entry
   launched no time fails the run.

Exits non-zero, printing no result line, without CUDA or without the port.
Imports nothing of JAX or of the JAX package.
"""
import json
import math
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
TIME_LIMIT_S = 280.0            # the whole run, build included
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "logs/flat_anymal_c/Aug21_12-38-39_r5_ft4/model_final.pkl")
ROUGH_CKPT = os.path.join(ROOT, "logs/rough_anymal_c/Aug21_13-00-24_r5_rough3/model_final.pkl")
FLAT_CKPT = os.path.join(ROOT, "logs/flat_anymal_c/Aug21_16-29-23_r5_scratch/model_final.pkl")
RAY_CKPT = os.path.join(ROOT, "logs/rough_raycast_anymal_c/Aug21_13-41-24_r5_rayc/model_final.pkl")
JAX_ESTIMATOR = os.path.join(ROOT,
                             "logs/terrain_estimator/anymal_c_rough_raycast/estimator_final.pkl")
CMD = 0.7

# kernel against plain, one control step (tests/test_physics_kernel.py:66-84):
# positions integrate from matching velocities, so they are tight; velocities
# carry float32 accumulation-order noise through the contact solve
ONE_STEP_ATOL = dict(base_pos=1e-4, base_quat=1e-4, joint_pos=5e-4, base_lin_vel=2e-2,
                     base_ang_vel=2e-2, joint_vel=5e-2, contact_anchor=1e-4, foot_pos=1e-4)
# the main path's batches at E=8: sampling rollouts (8 x 128), fd polish
# (8 x 97), line search (8 x 3), the main env step (8); the solve cell's at
# E=1 (128, 97, 3); the rollout cell's 2048 and the training fleet's 4096
# (three waves of 3 blocks of 4 envs per SM); the flat estimator evidence's
# 64 and the distillation fleet's 256
CHECK_B = (1024, 776, 24, 8, 128, 97, 3, 2048, 4096, 64, 256)
# B2: the rough evaluation's fleet, the estimator's and the rough config's
# training fleet
ROUGH_B = (32, 128, 4096)
ROUGH_STEPS = 20
# after 25 control steps (100 substeps) the stiction/contact dynamics amplify
# rounding differences (FMA contraction, summation order); the bounds are ~10x
# the divergence of the same code compiled for the host
DRIFT_ATOL = dict(base_pos=2e-2, base_quat=3e-2, joint_pos=0.1, base_lin_vel=0.1,
                  base_ang_vel=0.5, joint_vel=2.0)
# V-control routes: flat at the MPC path's batch, rough at the fleet's
V_FLAT_B, V_ROUGH_B, V_STEPS = 1024, 4096, 10
# training paths: the fleet and iterations of the TRAIN_r5 and
# TRAIN_ROUGH_r5 recipes (the ray path runs the same fleet)
FLEET = 4096
TRAIN_ITERS = 5
ROUGH_TRAIN_ITERS = 3
# ray path: control steps of the 4096-env ray task; its evaluation's command
RAY_STEPS = 20
RAY_CMD = 0.5
# the depth render may leave [0, 1] by float32 rounding of the resize's
# normalized weights (as jax.image.resize does)
DEPTH_SLACK = 1e-6
# estimator path: the closed loop's fleet, iterations of 24 steps, and the
# closed-loop segment with the JAX estimator
EST_ENVS, EST_ITERS, EST_CL_STEPS = 128, 2, 20
# distillation path: the DISTILL_NATIVE_r5 fleet and iterations of 24 steps
DISTILL_ENVS, DISTILL_ITERS = 256, 3
# ElSpider Air: B1 on its tables at the evaluation's 16 and the fleet's 4096,
# training iterations at the fleet; the SEA task's and the RL extensions'
# training iterations at the fleet
ELSPIDER_B, ELSPIDER_ITERS = (16, 4096), 3
# control steps of the hexapod's drift report (reported, not bounded)
ELSPIDER_DRIFT_STEPS = 2
SEA_ITERS, EXT_ITERS = 3, 1
# Franka (the fixed-base regime): B at franka_batch_rollout's 8 main envs
# and at franka_cfg's fleet of 1024 (also 8 main envs x 128 rollout
# samples); training iterations at that fleet; the rollout batch's main
# envs, samples and horizon
FRANKA_B, FRANKA_FLEET, FRANKA_ITERS = (8, 1024), 1024, 3
FRANKA_E, FRANKA_S, FRANKA_H = 8, 128, 16
# CyberDog2 on B1: the walk family's fleet, its training iterations
CYBER_B, CYBER_ITERS = 4096, 2
# the LeggedRobot family: each new (regime, tables) pair against plain at
# the fleet from near-standing states (B2 above its task's spawn origins on
# its own grid), its FAMILY_DRIFT_STEPS-step drift at FAMILY_DRIFT_B; the
# hanging hexapod's fixed base from the hang config's initial states and held at
# HANG_LOADED_Z, where its legs bear load; FAMILY_ITERS training
# iterations at the fleet of each FAMILY_TRAIN task and FAMILY_STEPS
# control steps of each FAMILY_STEP task
FAMILY_KERNELS = (("B1", "a1_flat"), ("B1", "go2_flat"), ("B2", "a1"), ("B2", "go2_rough"),
                  ("B2", "anymal_b"), ("B2", "cassie"), ("B2", "elspider_air_rough"))
# (0.175 m presses the default pose's feet 9 mm into the ground, as near_standing's
# heights do; at HANG_TIGHT_Z, 14 mm, float32 rounding alone moves the plain step by
# up to ONE_STEP_ATOL in a few envs, and track_float32 holds the kernel there)
FAMILY_DRIFT_B, HANG_LOADED_Z, HANG_TIGHT_Z = 32, 0.175, 0.17
FAMILY_DRIFT_STEPS = 2
FAMILY_TRAIN = ("a1", "go2_rough", "anymal_b", "cassie", "elspider_air_rough",
                "anymal_c_rough_teacher", "anymal_c_student", "pose_go2_flat",
                "foot_track_elspider_air_hang")
FAMILY_STEP = ("a1_flat", "go2_flat", "load_adapt_anymal_c", "pose_anymal_c", "stand_anymal_c",
               "load_adapt_go2_flat", "stand_go2_flat", "pose_elspider_air_flat",
               "foot_track_elspider_air_flat")
FAMILY_ITERS, FAMILY_STEPS = 2, 5
# rough family tasks whose curriculum cannot move a level in FAMILY_ITERS
# iterations, with the cause the run must show for the waiver to hold: the
# levels move only where an episode ends.  A1's base touches no ground in
# 48 control steps, and time-outs come at 1000; ElSpider's envs all start
# on the bottom row (max_init_terrain_level 0), which a short walk keeps,
# and a promotion needs half of an 8 m subterrain
CURRICULUM_WAIVED = {"a1": "no episode ended",
                     "elspider_air_rough": "every env started on the bottom row",
                     "elspider_air_rough_raycast": "every env started on the bottom row"}
# the confined, navigation, planning and perception slice: the ray cast's
# fleet and rays (4096 envs x 16 x 8 spherical rays), how many rays and SDF
# points are held to the float64 CPU version, their tolerances (m; the
# tolerances of tests/test_torch_trimesh.py, 1e-5, widened by the float32
# rounding of 10 m distances and of float32 tables read in float64; the SDF's
# gradient and nearest point, see check_sdf), the SDF gradient's length; the
# new (regime, tables) pairs at the MPC tasks' rollout batch (4 mains x 128
# samples) against plain; the two new training tasks at the fleet with their
# route; training iterations
CONFINED_RAY_ENVS, CONFINED_CHECK = 4096, 1024
RAY_ATOL, SDF_ATOL, SDF_DIR_ATOL, UNIT_ATOL = 1e-4, 1e-4, 1e-3, 1e-5
NEW_KERNELS = (("B1", "anymal_c_percept"), ("B1", "elspider_air_nav"),
               ("B2", "anymal_c_nav_barrier"))
NAV_B = 512
# the engine route against the CPU: the first ENGINE_CPU_B of NAV_B standing
# envs on elair_barrier_nav's arena
ENGINE_CPU_B = 32
NEW_TRAIN = (("anymal_c_flat_obstacles", "B1"), ("elspider_air_rough_raycast", "B2"))
NEW_ITERS = 2
# the polish modes' solves and the gradient checks: polish iterations per
# solve, the gradient check's horizon (dense steps - 1, nodes - 1), the
# tolerance as a multiple of the CPU's float32 - float64 gap
POLISH_MODES, POLISH_ITERS = ("none", "fd", "gradient", "ilqr"), 1
GRAD_HS, GRAD_HN, GRAD_TOL_FACTOR = 3, 1, 4.0
# the last slice's tasks: the sampling-MPC tasks with their route, the
# batch-rollout tasks with theirs (one rollout_batch of ROLLOUT_S samples,
# H=16), the pose-adapt tasks (POSE_STEPS steps, no kernel); the new kernel
# pairs (route, task, batch)
NEW_MPC = (("go2_dialmpc_flat", "B1"), ("go2_traj_grad_sampling", "B1"),
           ("cassie_traj_grad_sampling", "B1"), ("anymal_c_dialmpc_flat", "B1"),
           ("elspider_air_traj_grad_sampling", "B1"), ("elspider_air_dialmpc", "B2"),
           ("elspider_air_dialmpc_flat", "B1"))
NEW_ROLLOUT = (("anymal_c_batch_rollout", "B2"), ("anymal_c_batch_rollout_flat", "B1"),
               ("go2_batch_rollout", "B2"), ("go2_batch_rollout_flat", "B1"),
               ("elspider_air_batch_rollout", "B2"), ("elspider_air_batch_rollout_flat", "B1"))
ROLLOUT_S = 8
POSE_TASKS = ("anymal_c_base_pose_adapt", "anymal_c_base_pose_ctrl", "el_mini_base_pose_adapt",
              "el_mini_base_pose_ctrl")
POSE_STEPS = 2
ENGINE_DIFFUSE = 1                # elair_timberpile_nav's engine-route mpc_step: diffusion steps
TIMING_SOLVES = 10                # phase 41's timed solves
PAIRS_14 = (("B1", "cassie_traj_grad_sampling", 128), ("B1", "anymal_c_traj_grad_sampling", 1),
            ("B2", "elspider_air_dialmpc", 512))
# this slice: play's run (the committed flat checkpoint through the
# registry's --load_run), its batch and control steps (10 s / 0.02 s); the
# export's tolerance (TF32 off); the saturation sweep's sample counts (E=2,
# H=16: B1 at 2 x S) with its chains, and its weak-scaling row's samples per
# process; the command options' fleet and control steps
PLAY_RUN, PLAY_B, PLAY_STEPS = "Aug21_12-38-39_r5_ft4", 50, 500
EXPORT_ATOL = 1e-5
DP_TIMEOUT_S = 120                # phase 36's two gloo processes
SWEEP_S, SWEEP_REPS, WEAK_PER = (64, 512, 4096), 2, 16
CMD_ENVS, CMD_STEPS = 4096, 24
# the sim options' phase: the fleet with the armature and the velocity
# limits off, joint velocities past the 20 rad/s limit, control steps; the
# plain-engine solvers' envs
OPT_ENVS, OPT_ARMATURE, OPT_FAST, OPT_STEPS, OPT_ENGINE_ENVS = 4096, 0.05, 30.0, 4, 64
ELSPIDER_CKPT = os.path.join(ROOT, "logs/flat_elspider_air/Aug21_04-21-51_r4b/model_final.pkl")
SEA_CKPT = os.path.join(ROOT, "logs/flat_sea_anymal_c/Aug21_07-18-55_r4_sea2/model_final.pkl")


def log(msg):
    print(msg, flush=True)


def phase_done(name, t0):
    now = time.perf_counter()
    log(f"[{name}] {now - t0:.2f} s (total {now - T_START:.1f} s)")
    if now - T_START > TIME_LIMIT_S:
        raise SystemExit(f"chip_smoke: over the {TIME_LIMIT_S:.0f} s limit after phase {name}")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def compare_one_step(name, step, B, states, kernel_stats, plain_dtype=None):
    """One control step of ``step``'s kernel against its plain version from
    ``states`` = (phys, env_params, actions), the plain version computed in
    ``plain_dtype`` (default float32); fails beyond ONE_STEP_ATOL.  Against
    float64, an env whose own float32 and float64 plain steps part by more
    than ONE_STEP_ATOL (a contact decision that rounding flips, such as a
    foot on a stair's edge) is held to the float32 plain step, the others to
    the float64 one; their number is printed.  Times both (the plain version
    in float32) and records ms, plain ms and the bound in
    ``kernel_stats[B]``.  Returns the largest difference over the checked
    fields."""
    import torch

    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import launch_bound

    st, ep, act = states
    sk, tk, rk = step.launch(st, act, ep)
    sp_, tp, rp = step.plain(st, act, ep, dtype=plain_dtype)
    if plain_dtype is not None:
        sp32, tp32, rp32 = step.plain(st, act, ep)
        log(f"{name} B={B}: kernel - float32 plain: " + " ".join(
            f"{k}={(getattr(sk, k) - getattr(sp32, k)).abs().max().item():.3g}"
            for k in ("joint_pos", "joint_vel")) + "; float32 plain - float64 plain: " + " ".join(
            f"{k}={(getattr(sp32, k) - getattr(sp_, k)).abs().max().item():.3g}"
            for k in ("joint_pos", "joint_vel")) + f"; below: kernel - {plain_dtype} plain")
        if plain_dtype == torch.float64:
            env_err = lambda a, b: (a - b).abs().reshape(B, -1).amax(1)
            parted = torch.zeros(B, dtype=torch.bool, device=sk.base_pos.device)
            for k, tol in ONE_STEP_ATOL.items():
                a, b = ((rp32.foot_pos, rp.foot_pos) if k == "foot_pos"
                        else (getattr(sp32, k), getattr(sp_, k)))
                if a.numel():
                    parted |= env_err(a, b) > tol
            pick = lambda a, b: torch.where(parted.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
            sp_ = sp_.replace(**{k: pick(getattr(sp32, k), getattr(sp_, k))
                                 for k in ONE_STEP_ATOL if k != "foot_pos"})
            tp = pick(tp32, tp)
            rp = rp.__class__(*[pick(a, b) if isinstance(b, torch.Tensor) else b
                                for a, b in zip(rp32, rp)])
            log(f"{name} B={B}: {int(parted.sum())} env(s) whose float32 and float64 plain steps "
                f"part beyond ONE_STEP_ATOL, held to the float32 plain "
                f"{parted.nonzero().flatten().tolist()[:8]}")
    torch.cuda.synchronize()
    errs = {k: (getattr(sk, k) - getattr(sp_, k)).abs().max().item()
            for k in ONE_STEP_ATOL if k != "foot_pos"}
    errs["foot_pos"] = maxabs(rk.foot_pos - rp.foot_pos)
    errs["tau_last"] = (tk - tp).abs().max().item()
    fz_k, fz_p = rk.geom_forces[..., 2].sum(1), rp.geom_forces[..., 2].sum(1)
    fz_ok = bool(((fz_k - fz_p).abs() <= 30.0 + 0.2 * fz_p.abs()).all())
    log(f"{name} one step B={B}: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
        + f" fz_sum_max_diff={(fz_k - fz_p).abs().max().item():.3g} (rtol 0.2, atol 30)")
    for k, tol in ONE_STEP_ATOL.items():
        if not errs[k] <= tol:
            fail(f"{name} vs plain at B={B}: {k} differs by {errs[k]:.3g} > {tol}")
    if not fz_ok:
        fail(f"{name} vs plain at B={B}: vertical geom force sums disagree")
    for out in (sk, sp_):
        if not all(torch.isfinite(getattr(out, k)).all() for k in ONE_STEP_ATOL if k != "foot_pos"):
            fail(f"non-finite state after one {name} step at B={B}")
    bufs = step.pack(st, act, ep)
    kms = bench_mpc.cuda_ms(lambda: step.run(bufs), reps=20, warmup=3)
    wms = bench_mpc.cuda_ms(lambda: step.launch(st, act, ep), reps=20, warmup=3)
    # one timed call: the comparison above has run the plain step already
    pms = bench_mpc.cuda_ms(lambda: step.plain(st, act, ep))
    bound_ms, bound_by, flops, nbytes = launch_bound(step, B)
    kernel_stats[B] = dict(ms=kms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"{name} at B={B}: kernel {kms:.4f} ms/launch ({wms:.4f} ms with the wrapper's "
        f"packing), plain {pms:.3f} ms, bound {bound_ms * 1e3:.3f} us ({flops:.3g} flop, "
        f"{nbytes:.3g} bytes)")
    return max(errs[k] for k in ONE_STEP_ATOL)


def track_float32(name, step, B, states):
    """One control step of ``step``'s kernel from ``states`` where float32
    rounding alone moves the plain step by up to ONE_STEP_ATOL: the float32
    plain step is also run from 8 copies of the states whose joint
    positions and velocities each move by at most one float32 ulp, and each
    env's envelope is the furthest any of these float32 plain steps lies
    from the float64 plain step.  The kernel must lie within ONE_STEP_ATOL
    plus that envelope of the float64 plain step, env by env.  For each
    field it prints the largest and the mean over envs of kernel - float32
    plain, kernel - float64 plain, float32 - float64 plain and the float32
    plain's own spread under the ulp moves, the envs past the tolerance,
    and those envs one by one.  (Its differences stay out of the kernel
    line's max_abs_err, which holds the comparisons at the tolerance.)"""
    import torch

    st, ep, act = states
    sk, _, rk = step.launch(st, act, ep)
    s32, _, r32 = step.plain(st, act, ep)
    s64, _, r64 = step.plain(st, act, ep, dtype=torch.float64)
    gen = torch.Generator(device=st.joint_pos.device).manual_seed(0)

    def ulp(x):
        d = torch.randint(-1, 2, x.shape, generator=gen, device=x.device)
        return torch.where(d > 0, torch.nextafter(x, torch.full_like(x, math.inf)),
                           torch.where(d < 0, torch.nextafter(x, torch.full_like(x, -math.inf)), x))

    moved = [step.plain(st.replace(joint_pos=ulp(st.joint_pos), joint_vel=ulp(st.joint_vel)),
                        act, ep) for _ in range(8)]
    torch.cuda.synchronize()
    env_err = lambda a, b: (a.double() - b.double()).abs().reshape(B, -1).amax(1)
    get = lambda k, s, r: r.foot_pos if k == "foot_pos" else getattr(s, k)
    bad = []
    for k, tol in ONE_STEP_ATOL.items():
        a, b, c = get(k, sk, rk), get(k, s32, r32), get(k, s64, r64)
        if not a.numel():
            continue
        k32, k64, p = env_err(a, b), env_err(a, c), env_err(b, c)
        spread, envelope = torch.zeros_like(p), p.clone()
        for s_, _, r_ in moved:
            spread = torch.maximum(spread, env_err(get(k, s_, r_), b))
            envelope = torch.maximum(envelope, env_err(get(k, s_, r_), c))
        mm = lambda x: f"{x.max().item():.4g}/{x.mean().item():.4g}"
        log(f"{name} B={B} {k} (tol {tol:g}), max/mean over envs: kernel - float32 plain "
            f"{mm(k32)}, kernel - float64 plain {mm(k64)}, float32 - float64 plain {mm(p)}, "
            f"float32 plain's spread under 1-ulp input moves {mm(spread)}; envs past tol: "
            f"kernel - float32 {int((k32 > tol).sum())}, kernel - float64 "
            f"{int((k64 > tol).sum())}, float32 - float64 {int((p > tol).sum())}, float32 "
            f"spread {int((spread > tol).sum())}; kernel further from float64 than the float32 "
            f"plain in {int((k64 > p).sum())} envs")
        for i in ((k32 > tol) | (k64 > tol) | (spread > tol)).nonzero().flatten().tolist()[:8]:
            log(f"  env {i} {k}: kernel - float32 {k32[i].item():.4g}, kernel - float64 "
                f"{k64[i].item():.4g}, float32 - float64 {p[i].item():.4g}, float32 spread "
                f"{spread[i].item():.4g}, envelope {envelope[i].item():.4g}")
        over = k64 - envelope - tol
        if over.max().item() > 0:
            bad.append(f"{k} by {over.max().item():.3g} in {int((over > 0).sum())} envs")
    if bad:
        fail(f"{name}: the kernel lies further from the float64 plain than ONE_STEP_ATOL beyond "
             f"the float32 plain's envelope: {'; '.join(bad)}")


def maxabs(x) -> float:
    """The largest magnitude in ``x`` (0 for an empty tensor: a model
    without feet reports none)."""
    return x.abs().max().item() if x.numel() else 0.0


def bit_identical(name, step, B, states):
    """Two launches on the same inputs must give the same bits (every sum in
    the kernel has a fixed order)."""
    import torch

    st, ep, act = states
    a, b = step.launch(st, act, ep), step.launch(st, act, ep)
    torch.cuda.synchronize()
    fields = [(k, getattr(a[0], k), getattr(b[0], k)) for k in ONE_STEP_ATOL if k != "foot_pos"]
    fields += [("tau", a[1], b[1])] + [(k, getattr(a[2], k), getattr(b[2], k))
                                       for k in ("geom_forces", "foot_pos", "foot_vel")]
    bad = [k for k, x, y in fields if not torch.equal(x, y)]
    log(f"{name} two launches at B={B}: " + ("bit-identical" if not bad else f"differ in {bad}"))
    if bad:
        fail(f"{name}: two launches on the same inputs differ in {bad}")


def drift_report(name, step, B, states, steps=25):
    """drift_check's ``steps`` control steps, with the plain version run both in
    float32 and in float64: prints the kernel's drift from each and the
    float32 plain's own drift from float64, and fails only on non-finite
    states.  For a model whose trajectories from these states are chaotic
    (the float32 plain leaves float64 by more than DRIFT_ATOL), a drift
    bound cannot tell a kernel fault from rounding."""
    import torch

    st, ep, act = states
    act = 0.2 * act
    sk, s32, s64 = st, st, st
    for _ in range(steps):
        sk = step.launch(sk, act, ep)[0]
        s32 = step.plain(s32, act, ep)[0]
        s64 = step.plain(s64, act, ep, dtype=torch.float64)[0]
    torch.cuda.synchronize()
    for label, a, b in (("kernel - float32 plain", sk, s32), ("kernel - float64 plain", sk, s64),
                        ("float32 plain - float64 plain", s32, s64)):
        log(f"{name} drift after {steps} control steps B={B}, {label}: " + " ".join(
            f"{k}={(getattr(a, k) - getattr(b, k)).abs().max().item():.3g}" for k in DRIFT_ATOL))
    vmax = float(step.model.dof_vel_limits.min())
    log(f"{name}: joint velocities at the {vmax:g} rad/s limit after "
        f"{steps} steps: {int((s64.joint_vel.abs() > 0.99 * vmax).sum())}"
        f" (float64 plain)")
    if not all(torch.isfinite(getattr(sk, k)).all() for k in DRIFT_ATOL):
        fail(f"{name}: non-finite state after {steps} control steps")


def v_control(cfg):
    """V control with gains the explicit substep keeps stable (as in
    tests/test_torch_env.py)."""
    cfg.control.control_type = "V"
    cfg.control.stiffness = {"HAA": 10.0, "HFE": 10.0, "KFE": 10.0}
    cfg.control.damping = {"HAA": 0.01, "HFE": 0.01, "KFE": 0.01}
    return cfg


def drift_check(name, step, B, states):
    """25 control steps of kernel and plain from the same states (actions
    scaled by 0.2); fails beyond DRIFT_ATOL."""
    import torch

    st, ep, act = states
    act = 0.2 * act
    sk, sp_ = st, st
    for _ in range(25):
        sk = step.launch(sk, act, ep)[0]
        sp_ = step.plain(sp_, act, ep)[0]
    torch.cuda.synchronize()
    drift = {k: (getattr(sk, k) - getattr(sp_, k)).abs().max().item() for k in DRIFT_ATOL}
    log(f"{name} drift after 25 control steps B={B}: "
        + " ".join(f"{k}={v:.3g}" for k, v in drift.items()))
    for k, tol in DRIFT_ATOL.items():
        if not drift[k] <= tol:
            fail(f"{name} 25-step drift of {k} is {drift[k]:.3g} > {tol}")


def launch_counts():
    """The launch counters of the fused control step (B1, B2, either with a
    fixed base) and of the torques-in route (EnvStep: V control and the
    actuator network)."""
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk

    return {"B1": pk.DecimatedEnvStep.launches, "B2": pk.DecimatedEnvStep.rough_launches,
            "fixed": pk.DecimatedEnvStep.fixed_launches,
            "B1 torques-in": pk.EnvStep.launches, "B2 torques-in": pk.EnvStep.rough_launches,
            "fixed torques-in": pk.EnvStep.fixed_launches}


def zero_launch_counts():
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk

    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    pk.EnvStep.launches = pk.EnvStep.rough_launches = 0
    pk.DecimatedEnvStep.fixed_launches = pk.EnvStep.fixed_launches = 0


# the sinks each training path's MetricsWriter wrote, read from its run
# directory (phase 39 prints them)
SINKS_SEEN = set()


def training_path(dev, task, seed, iters, envs=FLEET, check=None):
    """``iters`` iterations of PPO on ``task`` at its training recipe
    (``envs`` envs, from scratch) through the task registry and
    OnPolicyRunner.learn, then a save/load round trip.  On a generated
    terrain every level must lie in [0, num_rows) and the curriculum must
    have moved some env's level, unless the task is one of
    CURRICULUM_WAIVED and the run shows its cause.  ``check(runner, rows)``
    adds the task's own checks on the runner and its metrics rows.  Returns
    the launches of the physics route of the task (B1 flat, B2 rough,
    "fixed" on a fixed base; their torques-in route, one launch per substep,
    with the actuator network) in the learn call; no other route may
    launch."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.utils.task_registry import get_args, task_registry

    args = get_args(argv=["--task", task, "--seed", str(seed), "--num_envs", str(envs),
                          "--max_iterations", str(iters), "--device", str(dev)])
    env, _ = task_registry.make_env(args.task, args)
    rough = env.custom_origins
    ours = (("fixed" if env.model.fix_base else "B2" if rough else "B1")
            + (" torques-in" if env.substep is not None else ""))
    with tempfile.TemporaryDirectory() as root:
        runner, train_cfg = task_registry.make_alg_runner(env, args.task, args, log_root=root)
        net = runner.network
        log(f"{task} training: {env.num_envs} envs, obs {env.num_obs}, actor "
            f"{train_cfg.policy.actor_hidden_dims}, T={runner.num_steps_per_env}, "
            f"{train_cfg.algorithm.num_learning_epochs} epochs x "
            f"{train_cfg.algorithm.num_mini_batches} minibatches, seed {train_cfg.seed}")
        before = torch.cat([p.detach().reshape(-1) for p in net.parameters()]).clone()
        levels0 = runner.env_state.terrain_levels.clone()
        torch.cuda.synchronize()
        zero_launch_counts()
        runner.learn(train_cfg.runner.max_iterations, log_interval=1)
        torch.cuda.synchronize()
        counts = launch_counts()
        with open(os.path.join(runner.log_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        SINKS_SEEN.add(("JSONL",) + (("TensorBoard",) if any(
            f.startswith("events.out.tfevents") for f in os.listdir(runner.log_dir)) else ()))
        after = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
        want = iters * runner.num_steps_per_env * (
            env.cfg.control.decimation if env.substep is not None else 1)
        others = {k: v for k, v in counts.items() if k != ours}
        log(f"{task} training path: {ours} launches={counts[ours]} (want {want}), others "
            f"{others}; losses " + " ".join(f"{r['loss']:.4g}" for r in rows)
            + "; nonfinite_skips " + " ".join(f"{r['nonfinite_skips']:g}" for r in rows)
            + f"; learning rate {rows[-1]['learning_rate']:.3g}; reward stage "
            f"{rows[-1].get('reward_stage', 0):g}")
        if counts[ours] != want or any(others.values()):
            fail(f"the {task} training path launched {ours} {counts[ours]} times (want {want}) "
                 f"and others {others} (want 0)")
        if not all(math.isfinite(r["loss"]) for r in rows) or not torch.isfinite(after).all():
            fail(f"non-finite loss or parameters on the {task} training path")
        if any(r["nonfinite_skips"] != 0 for r in rows):
            fail(f"the {task} training path skipped updates for non-finite values")
        if torch.equal(before, after):
            fail(f"the {task} training path left the parameters unchanged")
        if rough:
            levels = runner.env_state.terrain_levels
            moved = int((levels != levels0).sum())
            lo, hi = int(levels.min()), int(levels.max())
            ended = sum(r["episodes_done"] for r in rows)
            log(f"terrain curriculum: {moved} of {env.num_envs} envs changed level; levels "
                f"{lo}..{hi} (rows {env.max_terrain_level}), mean "
                + " -> ".join(f"{r['terrain_level']:.3f}" for r in rows)
                + f"; {ended:g} episodes ended, starting levels {int(levels0.min())}.."
                f"{int(levels0.max())}")
            if moved == 0:
                why = CURRICULUM_WAIVED.get(task)
                shown = {"no episode ended": ended == 0,
                         "every env started on the bottom row": int(levels0.max()) == 0}
                if why is None or not shown[why]:
                    fail(f"the {task} training path moved no env's terrain level")
                log(f"{task}: no level moved, as expected here: {why}")
            if lo < 0 or hi >= env.max_terrain_level:
                fail(f"terrain levels {lo}..{hi} outside [0, {env.max_terrain_level})")
        if check is not None:
            check(runner, rows)
        steady = rows[1:] or rows
        col = sum(r["collection_s"] for r in steady) / len(steady)
        upd = sum(r["update_s"] for r in steady) / len(steady)
        log(f"{task} training iteration (mean of iterations 2-{len(rows)}): {col + upd:.4f} s = "
            f"collection {col:.4f} s + update {upd:.4f} s; "
            f"{env.num_envs * runner.num_steps_per_env / (col + upd):.0f} env-steps/s "
            f"(first iteration {rows[0]['collection_s'] + rows[0]['update_s']:.3f} s)")

        path = os.path.join(root, "roundtrip.pkl")
        runner.save(path)
        fresh = OnPolicyRunner(env, train_cfg)
        fresh.load(path)
        obs = runner.env_state.obs
        a, b = runner.get_inference_policy()(obs), fresh.get_inference_policy()(obs)
        log(f"save/load round trip: iteration {fresh.iteration}, actions equal "
            f"{torch.equal(a, b)} (max diff {(a - b).abs().max().item():.3g})")
        if not torch.equal(a, b):
            fail("the loaded runner's policy gives other actions than the saved one's")
    return counts[ours]


def ray_path(dev):
    """The ray-observation task at 4096 envs stepped by the committed ray
    checkpoint, the ray cast's time, a short ray evaluation and the depth
    camera.  Returns B2's launches in the stepped run."""
    import torch

    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.envs.legged_robot_config import DepthCfg
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.perception.depth_camera import DepthCameraRaycast
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.eval_rough import eval_cfg, load_policy, run_eval

    t0 = time.perf_counter()
    env = LeggedRobot(eval_cfg(FLEET, task="anymal_c_rough_raycast"), device=dev)
    policy = load_policy(RAY_CKPT, env.num_obs, env.num_actions, dev)
    cmd = torch.zeros(env.num_envs, 4, device=dev)
    cmd[:, 0] = RAY_CMD
    with torch.no_grad():
        state = env.reset_all(seed=0).replace(commands=cmd)
        pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
        up, tail_ok = [], True
        for _ in range(RAY_STEPS):
            state = env.step(state, policy(state.obs)).replace(commands=cmd)
            up.append(state.projected_gravity[:, 2])
            tail = state.obs[:, 235:]
            tail_ok = tail_ok and bool(torch.isfinite(state.obs).all()
                                       and ((tail >= 0.0) & (tail <= 1.0)).all())
        torch.cuda.synchronize()
        launches, b1 = pk.DecimatedEnvStep.rough_launches, pk.DecimatedEnvStep.launches
        upright = torch.stack(up).mean().item()
        log(f"ray path: {RAY_STEPS} control steps, {env.num_envs} envs, obs "
            f"{tuple(state.obs.shape)} ({env.raycaster.num_rays} rays): B2 launches={launches} "
            f"B1 launches={b1} upright_mean={upright:.4f} ray tail finite and in [0, 1]={tail_ok} "
            f"mean {state.obs[:, 235:].mean().item():.4f}")
        if launches != RAY_STEPS or b1:
            fail(f"the ray path launched B2 {launches} times (want {RAY_STEPS}) and B1 {b1}")
        if tuple(state.obs.shape) != (env.num_envs, 267) or not tail_ok:
            fail("the ray observation is not 267 wide with a finite ray tail in [0, 1]")
        if not upright < -0.9:
            fail(f"ray-path robots did not stay upright (upright_mean {upright:.3f})")
        pos, quat = state.phys.base_pos, state.phys.base_quat
        cast_ms = bench_mpc.cuda_ms(lambda: env.raycaster.cast(pos, quat), reps=20, warmup=3)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(RAY_STEPS):
            state = env.step(state, policy(state.obs)).replace(commands=cmd)
        torch.cuda.synchronize()
        sps = RAY_STEPS / (time.perf_counter() - t1)
        log(f"ray cast at {env.num_envs} envs x {env.raycaster.num_rays} rays: {cast_ms:.4f} ms "
            f"per call (CUDA events); ray env {sps:.2f} control steps/s, policy included")
    res = run_eval(RAY_CKPT, 128, 100, 50, RAY_CMD, max_init_level=2, seed=7, device=dev,
                   task="anymal_c_rough_raycast")
    log(f"short ray eval (128 envs, 50+100 steps, levels <= 2, {RAY_CMD} m/s): achieved/command="
        f"{res['achieved_over_command']} upright_mean={res['upright_mean']} falls={res['falls']} "
        f"by type {res['falls_by_terrain_type']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the short ray eval")
    phase_done("ray path", t0)

    t0 = time.perf_counter()
    dcfg = DepthCfg()
    dcfg.camera_type, dcfg.original, dcfg.resized = "Warp", [48, 24], [32, 16]
    cam = DepthCameraRaycast(dcfg, env.num_envs, env.terrain, device=dev)
    with torch.no_grad():
        frame = cam.render(pos, quat)
        render_ms = bench_mpc.cuda_ms(lambda: cam.render(pos, quat), reps=10, warmup=2)
    ok = bool(torch.isfinite(frame).all()) and -DEPTH_SLACK <= frame.min().item() \
        and frame.max().item() <= 1.0 + DEPTH_SLACK
    log(f"depth camera: {env.num_envs} envs, {dcfg.original[0]} x {dcfg.original[1]} rays -> "
        f"{tuple(frame.shape[1:])}: {render_ms:.4f} ms per render (CUDA events), range "
        f"[{frame.min().item():.4g}, {frame.max().item():.4g}], mean {frame.mean().item():.4f}")
    if tuple(frame.shape) != (env.num_envs, 16, 32) or not ok:
        fail(f"the depth render is not finite in [0, 1] at {env.num_envs} x 16 x 32")
    phase_done("depth camera", t0)
    return launches


def flat_params(params):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in params]).clone()


def estimator_path(dev):
    """The terrain estimator trained on the ray task with the ray policy
    driving, its checkpoint round trip, the render and iteration times, and
    the committed JAX estimator in a closed-loop segment.  Returns B2's
    launches in the training and the segment."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.rl.terrain_estimator_runner import TerrainEstimatorRunner
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.estimator_closed_loop import build_env, rollout
    from extended_legged_gym_tpu_torch.scripts.eval_rough import load_policy

    t0 = time.perf_counter()
    env = build_env(EST_ENVS, 2, dev)
    policy = load_policy(RAY_CKPT, env.num_obs, env.num_actions, dev)
    te = TerrainEstimatorRunner(env, seed=0, policy=policy)
    before = flat_params(te.network.parameters())
    torch.cuda.synchronize()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    last = te.learn(EST_ITERS, log_interval=1)
    torch.cuda.synchronize()
    b2, b1 = pk.DecimatedEnvStep.rough_launches, pk.DecimatedEnvStep.launches
    after = flat_params(te.network.parameters())
    want = EST_ITERS * te.num_steps_per_env
    log(f"estimator path: {EST_ITERS} iterations, {env.num_envs} envs, {te.raycaster.num_rays} "
        f"rays, frames {te.camera.H1} x {te.camera.W1}: B2 "
        f"launches={b2} (want {want}) B1 launches={b1}; loss {last['loss']:.5g}; iteration "
        f"{last['iter_time']:.4f} s = collection {last['collection_s']:.4f} s + update "
        f"{last['update_s']:.4f} s (the last)")
    if b2 != want or b1:
        fail(f"the estimator path launched B2 {b2} times (want {want}) and B1 {b1}")
    if not math.isfinite(last["loss"]) or not torch.isfinite(after).all():
        fail("non-finite loss or parameters on the estimator path")
    if torch.equal(before, after):
        fail("the estimator path left the parameters unchanged")
    with torch.no_grad():
        state = env.reset_all(seed=0)
        pos, quat = state.phys.base_pos, state.phys.base_quat
        frame, proprio = te.camera.render(pos, quat), te._proprio(state)
        with tempfile.TemporaryDirectory() as root:
            path = os.path.join(root, "estimator_final.pkl")
            te.save(path)
            fresh = TerrainEstimatorRunner(env, seed=1, policy=policy)
            fresh.load(path)
        a = te.get_estimator()(frame, proprio, te.carry0)[0]
        b = fresh.get_estimator()(frame, proprio, fresh.carry0)[0]
        render_ms = bench_mpc.cuda_ms(lambda: te.camera.render(pos, quat), reps=10, warmup=2)
    log(f"estimator save/load round trip: predictions equal {torch.equal(a, b)}; depth render at "
        f"{env.num_envs} envs: {render_ms:.4f} ms (CUDA events)")
    if not torch.equal(a, b):
        fail("the loaded estimator predicts other distances than the saved one")

    jte = TerrainEstimatorRunner(env, seed=0, policy=policy)
    jte.load(JAX_ESTIMATOR)
    torch.cuda.synchronize()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    res = rollout(env, jte, policy, True, warmup=0, steps=EST_CL_STEPS, cmd_mps=RAY_CMD, seed=7)
    torch.cuda.synchronize()
    seg, b1 = pk.DecimatedEnvStep.rough_launches, pk.DecimatedEnvStep.launches
    log(f"closed-loop segment with the JAX estimator ({EST_CL_STEPS} steps, ray tail swapped): "
        f"B2 launches={seg} B1 launches={b1}; RMSE {res['rmse']:.4f} m, near-3 m "
        f"{res['near_rmse']:.4f} m, tracking {res['vx'] / RAY_CMD:.4f}, upright_mean "
        f"{res['upright']:.4f}, resets {res['resets']:g}")
    if seg != EST_CL_STEPS or b1:
        fail(f"the closed-loop segment launched B2 {seg} times (want {EST_CL_STEPS}) and B1 {b1}")
    if not all(math.isfinite(res[k]) for k in ("rmse", "mae", "near_rmse", "vx")):
        fail("non-finite predictions in the closed-loop segment")
    if not res["upright"] < -0.9:
        fail(f"closed-loop robots did not stay upright (upright_mean {res['upright']:.3f})")
    phase_done("estimator path", t0)
    return b2 + seg


def distill_path(dev):
    """DISTILL_ITERS iterations of the distillation recipe at its fleet.
    Returns B1's launches."""
    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.evidence_artifacts import distill_runner

    t0 = time.perf_counter()
    runner = distill_runner(CKPT, DISTILL_ENVS, DISTILL_ITERS, dev)
    obs = runner.env_state.obs.clone()
    with torch.no_grad():
        teacher_out = runner.teacher_policy(obs).clone()
    student = flat_params(runner.alg.optimizer.params)
    teacher_slot = flat_params(runner.network.teacher.parameters())
    torch.cuda.synchronize()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    last = runner.learn(DISTILL_ITERS, log_interval=1)
    torch.cuda.synchronize()
    b1, b2 = pk.DecimatedEnvStep.launches, pk.DecimatedEnvStep.rough_launches
    want = DISTILL_ITERS * runner.num_steps_per_env
    student_after = flat_params(runner.alg.optimizer.params)
    with torch.no_grad():
        teacher_same = torch.equal(runner.teacher_policy(obs), teacher_out) and torch.equal(
            flat_params(runner.network.teacher.parameters()), teacher_slot)
    log(f"distillation path: {DISTILL_ITERS} iterations, {runner.env.num_envs} envs, student "
        f"(256, 256, 128): B1 launches={b1} (want {want}) B2 launches={b2}; behavior loss "
        f"{last['behavior_loss']:.5g}; {runner.alg.num_updates} optimizer steps, learning rate "
        f"{runner.alg.learning_rate:.4g}; teacher unchanged {teacher_same}; iteration "
        f"{last['collection_s'] + last['update_s']:.4f} s = collection {last['collection_s']:.4f} "
        f"s + update {last['update_s']:.4f} s (the last)")
    if b1 != want or b2:
        fail(f"the distillation path launched B1 {b1} times (want {want}) and B2 {b2}")
    if not math.isfinite(last["behavior_loss"]) or not torch.isfinite(student_after).all():
        fail("non-finite loss or student parameters on the distillation path")
    if torch.equal(student, student_after):
        fail("the distillation path left the student's parameters unchanged")
    if not teacher_same:
        fail("the distillation path changed the teacher")
    phase_done("distillation path", t0)
    return b1


def elspider_path(dev, stats):
    """B1 with the ElSpider Air tables against plain (one control step at
    ELSPIDER_B, the ELSPIDER_DRIFT_STEPS-step drift at 16, two launches bit
    for bit at 4096;
    ms, plain ms and bound into ``stats``), ELSPIDER_ITERS iterations of
    elspider_air_flat training at the fleet (B1 exactly ELSPIDER_ITERS x 24
    on the hexapod's tables), and a short evaluation of the committed JAX
    checkpoint.  The plain version runs in float64 here: on the hexapod's
    light legs its float32 rounding alone moves a joint velocity by about
    0.045 rad/s in a control step from near-standing states with random
    actions (at 4096 envs, against float64), most of ONE_STEP_ATOL's 5e-2.
    The drift is reported, not bounded (drift_report): from these
    states some knees chatter against the joint velocity limit and the
    float32 plain leaves the float64 plain by several rad/s.  Returns the
    largest difference against plain and B1's launches in the training and
    the evaluation."""
    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, near_standing,
                                                                    task_step)
    from extended_legged_gym_tpu_torch.scripts.eval_policy import evaluate

    t0 = time.perf_counter()
    step = task_step("elspider_air_flat", dev)
    m, h = step.model, STAND_HEIGHT["elspider_air"]
    log(f"ElSpider B1 (nb={m.nb} nj={m.nj} ng={m.ng} nf={step.nf}) block of {pk.ENVS_PER_BLOCK} "
        f"envs: {pk.block_shared_bytes(m.nb, m.nj, m.ng, step.nf)} bytes of shared memory")
    err = max(compare_one_step("ElSpider B1", step, B, near_standing(m, B, B, dev, height=h), stats,
                               torch.float64) for B in ELSPIDER_B)
    drift_report("ElSpider B1", step, 16, near_standing(m, 16, 7, dev, height=h),
                 ELSPIDER_DRIFT_STEPS)
    bit_identical("ElSpider B1", step, 4096, near_standing(m, 4096, 3, dev, height=h))
    phase_done("ElSpider B1 vs plain", t0)

    t0 = time.perf_counter()
    train = training_path(dev, "elspider_air_flat", 1, ELSPIDER_ITERS)
    phase_done("ElSpider training path", t0)

    t0 = time.perf_counter()
    zero_launch_counts()
    res = evaluate("elspider_air_flat", ELSPIDER_CKPT, envs=16, steps=100, warmup=50, device=dev)
    ev = launch_counts()["B1"]
    log(f"ElSpider evaluation of the committed JAX checkpoint (16 envs, 50+100 steps, "
        f"{res['command_mps']} m/s): achieved/command={res['achieved_over_command']} "
        f"upright_mean={res['upright_mean']} base_height_mean={res['base_height_mean']} "
        f"falls={res['falls']}; B1 launches={ev}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the ElSpider evaluation")
    if not res["upright_mean"] < -0.9 or ev != 150:
        fail(f"ElSpider evaluation: upright_mean {res['upright_mean']}, B1 launches {ev} (want 150)")
    phase_done("ElSpider evaluation", t0)
    return err, train + ev


def sea_path(dev, stats):
    """The SEA route: the anymal_c_flat_sea env's torques-in B1 step
    (EnvStep) against plain at the fleet with the actuator network's torques
    (ms, plain ms and bound into ``stats``), SEA_ITERS training iterations
    at the fleet (EnvStep exactly SEA_ITERS x 24 x 4, the fused step never),
    and a short evaluation of the committed JAX SEA checkpoint.  Returns the
    largest difference against plain and the route's launches."""
    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import STAND_HEIGHT, near_standing
    from extended_legged_gym_tpu_torch.scripts.eval_policy import evaluate
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    t0 = time.perf_counter()
    cfg, _ = task_registry.get_cfgs("anymal_c_flat_sea")
    cfg.env.num_envs = FLEET
    env, _ = task_registry.make_env("anymal_c_flat_sea", env_cfg=cfg, device=dev)
    if env.substep is None or env.decimated_step is not None or env.actuator_net is None:
        fail("the SEA env does not run the actuator network on the torques-in route")
    st, ep, act = near_standing(env.model, FLEET, 9, dev, height=STAND_HEIGHT["anymal_c"])
    with torch.no_grad():
        hidden = env.actuator_net.init_hidden((FLEET, env.num_dof))
        for _ in range(3):                      # a hidden state that has seen some steps
            tau, hidden = env._compute_torques(act, st, None, hidden)
    err = compare_one_step("SEA EnvStep", env.substep, FLEET, (st, ep, tau), stats)
    log(f"SEA torques at the fleet: |max| {tau.abs().max().item():.3g} N m")
    phase_done("SEA route vs plain", t0)

    t0 = time.perf_counter()
    launches = training_path(dev, "anymal_c_flat_sea", 2, SEA_ITERS)
    phase_done("SEA training path", t0)

    t0 = time.perf_counter()
    res = evaluate("anymal_c_flat_sea", SEA_CKPT, envs=16, steps=100, warmup=50, device=dev)
    log(f"SEA evaluation of the committed JAX checkpoint (16 envs, 50+100 steps, "
        f"{res['command_mps']} m/s): achieved/command={res['achieved_over_command']} "
        f"upright_mean={res['upright_mean']} base_height_mean={res['base_height_mean']} "
        f"falls={res['falls']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the SEA evaluation")
    if not res["upright_mean"] < -0.9:
        fail(f"SEA evaluation: robots did not stay upright (upright_mean {res['upright_mean']})")
    phase_done("SEA evaluation", t0)
    return err, launches


def base_unchanged(name, before, after):
    """A fixed base's pose and velocities must come out of the kernel bit for
    bit as they went in (states at rest, the identity orientation)."""
    import torch

    bad = [k for k in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel")
           if not torch.equal(getattr(before, k), getattr(after, k))]
    log(f"{name}: fixed base " + ("unchanged bit for bit" if not bad else f"moved in {bad}"))
    if bad:
        fail(f"{name}: the fixed base moved ({bad})")


def franka_path(dev, stats):
    """The fixed-base regime with the Franka arm's tables (8 bodies, 7 joints,
    one sphere on the base, no feet) against plain: one control step at
    FRANKA_B from states at rest with random actions, the 25-step drift at 8
    reported (drift_report: the arm's 2.2-2.6 rad/s velocity limits clamp
    often), two launches bit for bit at the fleet, the base unchanged bit
    for bit after one step and after the drift (ms, plain ms and bound into
    ``stats``); then the ``franka`` task through the registry for
    FRANKA_ITERS iterations at its fleet (the fixed-base route exactly
    FRANKA_ITERS x 24, B1 and B2 0) and ``franka_batch_rollout``'s
    ``rollout_batch`` at FRANKA_E main envs x FRANKA_S samples x FRANKA_H
    steps (exactly FRANKA_H launches, finite rewards).  Returns the largest
    difference against plain and the launches of both paths."""
    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import at_rest, franka_step
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    t0 = time.perf_counter()
    step = franka_step(dev)
    m = step.model
    log(f"fixed-base regime, Franka (nb={m.nb} nj={m.nj} ng={m.ng} nf={step.nf}, fix_base="
        f"{m.fix_base}) block of {pk.ENVS_PER_BLOCK} envs: "
        f"{pk.block_shared_bytes(m.nb, m.nj, m.ng, step.nf)} bytes of shared memory")
    err = max(compare_one_step("fixed-base", step, B, at_rest(m, B, B, dev), stats)
              for B in FRANKA_B)
    st, ep, act = at_rest(m, FRANKA_FLEET, 4, dev)
    base_unchanged("fixed-base one step", st, step.launch(st, act, ep)[0])
    st, ep, act = at_rest(m, 8, 7, dev)
    drift_report("fixed-base", step, 8, (st, ep, act))
    sk = st
    for _ in range(25):
        sk = step.launch(sk, 0.2 * act, ep)[0]
    base_unchanged("fixed-base 25 control steps", st, sk)
    bit_identical("fixed-base", step, FRANKA_FLEET, at_rest(m, FRANKA_FLEET, 3, dev))
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("fixed-base regime vs plain", t0)

    t0 = time.perf_counter()
    train = training_path(dev, "franka", 1, FRANKA_ITERS, envs=FRANKA_FLEET)
    phase_done("Franka training path", t0)

    t0 = time.perf_counter()
    cfg, _ = task_registry.get_cfgs("franka_batch_rollout")
    env, _ = task_registry.make_env("franka_batch_rollout", env_cfg=cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        state = env.reset_all(seed=0)
        us = 0.5 * torch.randn(FRANKA_E, FRANKA_S, FRANKA_H, env.num_actions, device=dev,
                               generator=gen)
        torch.cuda.synchronize()
        zero_launch_counts()
        t1 = time.perf_counter()
        rew = env.rollout_batch(state, us)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
    counts = launch_counts()
    others = {k: v for k, v in counts.items() if k != "fixed"}
    log(f"franka_batch_rollout: rollout_batch {env.num_envs} main envs x {FRANKA_S} samples x "
        f"H={FRANKA_H}: {ms:.1f} ms, fixed-base launches={counts['fixed']} (want {FRANKA_H}), "
        f"others {others}; rewards {tuple(rew.shape)} mean {rew.mean().item():.4g}")
    if counts["fixed"] != FRANKA_H or any(others.values()):
        fail(f"the Franka rollout launched the fixed-base route {counts['fixed']} times "
             f"(want {FRANKA_H}) and others {others}")
    if env.num_envs != FRANKA_E or tuple(rew.shape) != (FRANKA_E, FRANKA_S, FRANKA_H):
        fail(f"the Franka rollout's rewards have shape {tuple(rew.shape)}")
    if not bool(torch.isfinite(rew).all()):
        fail("non-finite rewards on the Franka rollout")
    phase_done("Franka rollout", t0)
    return err, train + counts["fixed"]


def cyberdog2_path(dev, stats):
    """B1 with CyberDog2's tables (13 bodies, 12 joints, 37 spheres, 4 feet)
    against plain (float64, as for the hexapod's light legs) at the walk
    family's fleet from near-standing states, two launches bit for bit (ms,
    plain ms and bound into ``stats``); then CYBER_ITERS iterations of
    ``cyber2_walk`` training at the fleet (B1 exactly CYBER_ITERS x 24).
    Returns the largest difference against plain and B1's launches."""
    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, near_standing,
                                                                    task_step)

    t0 = time.perf_counter()
    step = task_step("cyber2_walk", dev)
    m, h = step.model, STAND_HEIGHT["cyberdog2"]
    log(f"CyberDog2 B1 (nb={m.nb} nj={m.nj} ng={m.ng} nf={step.nf}) block of "
        f"{pk.ENVS_PER_BLOCK} envs: {pk.block_shared_bytes(m.nb, m.nj, m.ng, step.nf)} bytes of "
        f"shared memory")
    states = near_standing(m, CYBER_B, 5, dev, height=h)
    err = compare_one_step("CyberDog2 B1", step, CYBER_B, states, stats, torch.float64)
    st, ep, act = states
    fz = step.plain(st, act, ep)[2].geom_forces[..., 2].sum(1)
    log(f"CyberDog2: {int((fz > 0).sum())} of {CYBER_B} robots touch the ground")
    bit_identical("CyberDog2 B1", step, CYBER_B, near_standing(m, CYBER_B, 3, dev, height=h))
    phase_done("CyberDog2 B1 vs plain", t0)

    t0 = time.perf_counter()
    train = training_path(dev, "cyber2_walk", 1, CYBER_ITERS)
    phase_done("CyberDog2 training path", t0)
    return err, train


def route_of(env):
    """The launch counter of ``env``'s fused physics step."""
    return "fixed" if env.model.fix_base else "B2" if env.decimated_step.rough else "B1"


def family_kernels(dev, stats):
    """Each new (regime, tables) pair of FAMILY_KERNELS against its plain
    version (float64: the light legs; an env where float32 and float64 part
    is held to float32, as compare_one_step does) at the fleet from
    near-standing states (B2 on its own task's grid above the spawn
    origins), each block's shared memory, the FAMILY_DRIFT_STEPS-step drift
    at FAMILY_DRIFT_B reported, two launches bit for bit at the fleet; then
    the fixed-base regime with the hanging hexapod's tables from the hang config's initial states (random actions;
    the feet in contact counted, the base unchanged bit for bit after 1 and
    25 steps), with its base held at HANG_LOADED_Z (legs loaded), and held
    at HANG_TIGHT_Z (track_float32).  ms,
    plain ms and bound of each go into ``stats[(route, robot)]``.  Returns
    the largest difference against plain of each pair."""
    import torch

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (at_rest, task_env,
                                                                    task_states)

    t0 = time.perf_counter()
    errs = {}
    for route, task in FAMILY_KERNELS:
        env = task_env(task, dev, FLEET)
        step, m, robot = env.decimated_step, env.model, env.cfg.asset.name
        name = f"{route} {robot}"
        if route_of(env) != route:
            fail(f"{task}'s physics step is not {route}")
        log(f"{name} (nb={m.nb} nj={m.nj} ng={m.ng} nf={step.nf}) block of {pk.ENVS_PER_BLOCK} "
            f"envs: {pk.block_shared_bytes(m.nb, m.nj, m.ng, step.nf, step.rough)} bytes of "
            f"shared memory" + (f"; {task}'s grid {env.terrain.shape[0]} x "
                                f"{env.terrain.shape[1]}" if step.rough else ""))
        stats[(route, robot)] = {}
        errs[(route, robot)] = compare_one_step(name, step, FLEET,
                                                task_states(env, FLEET, FLEET, dev),
                                                stats[(route, robot)], torch.float64)
        drift_report(name, step, FAMILY_DRIFT_B, task_states(env, FAMILY_DRIFT_B, 7, dev),
                     FAMILY_DRIFT_STEPS)
        bit_identical(name, step, FLEET, task_states(env, FLEET, 3, dev))
    phase_done("family kernels vs plain", t0)

    t0 = time.perf_counter()
    env = task_env("foot_track_elspider_air_hang", dev, FLEET)
    step, m = env.decimated_step, env.model
    if route_of(env) != "fixed":
        fail("the hanging hexapod's physics step is not the fixed-base regime")
    gen = torch.Generator(device=dev).manual_seed(0)
    s0 = env.reset_all(seed=0)
    st, ep = s0.phys, s0.env_params
    act = torch.randn(FLEET, m.nj, device=dev, generator=gen)
    feet = torch.as_tensor(m.foot_geom, device=dev)
    stats[("fixed", "elspider_air")] = {}
    err = compare_one_step("fixed elspider_air (hang)", step, FLEET, (st, ep, act),
                           stats[("fixed", "elspider_air")], torch.float64)
    sk, _, rk = step.launch(st, act, ep)
    base_unchanged("fixed elspider_air one step", st, sk)
    for _ in range(24):
        sk, _, rk = step.launch(sk, act, ep)
    base_unchanged("fixed elspider_air 25 control steps", st, sk)
    touch = (rk.geom_forces[:, feet, 2] > 1.0).sum().item()
    log(f"hanging hexapod at {float(st.base_pos[0, 2]):.3f} m: feet in contact after 1 step "
        f"{int((step.launch(st, act, ep)[2].geom_forces[:, feet, 2] > 1.0).sum())}, after 25 "
        f"steps {int(touch)} of {FLEET * m.num_feet}")
    loaded = at_rest(m, FLEET, 5, dev,
                     torch.tensor([0.0, 0.0, HANG_LOADED_Z], device=dev).expand(FLEET, 3))
    lst, lep, lact = loaded
    fz = step.plain(lst, lact, lep)[2].geom_forces[:, feet, 2]
    log(f"hanging hexapod held at {HANG_LOADED_Z} m: {int((fz > 1.0).sum())} of "
        f"{FLEET * m.num_feet} feet loaded (mean {fz.mean().item():.1f} N)")
    err = max(err, compare_one_step("fixed elspider_air (loaded)", step, FLEET, loaded, {},
                                    torch.float64))
    base_unchanged("fixed elspider_air loaded", lst, step.launch(lst, lact, lep)[0])
    bit_identical("fixed elspider_air", step, FLEET, loaded)
    tight = at_rest(m, FLEET, 5, dev,
                    torch.tensor([0.0, 0.0, HANG_TIGHT_Z], device=dev).expand(FLEET, 3))
    track_float32(f"fixed elspider_air at {HANG_TIGHT_Z} m", step, FLEET, tight)
    errs[("fixed", "elspider_air")] = err
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("hanging hexapod fixed base vs plain", t0)
    return errs


def family_training(dev, launches):
    """FAMILY_ITERS PPO iterations at the fleet of each FAMILY_TRAIN task
    through the registry (training_path: its route exactly FAMILY_ITERS x
    24, the others 0).  The teacher's and the student's critic must read
    the 235-wide privileged observation; Cassie's termination episode sum
    must be finite, and non-zero where an episode ended.  Adds each task's
    launches to ``launches[(route, robot)]``."""
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    def priv_critic(runner, rows):
        width = runner.network.critic[0].in_features
        log(f"critic input {width} (privileged observation {runner.env.num_privileged_obs}), "
            f"actor input {runner.network.actor[0].in_features}")
        if width != 235 or runner.env_state.privileged_obs.shape[1] != 235:
            fail(f"the critic reads {width} inputs, not the 235-dim privileged observation")

    def termination(runner, rows):
        done = sum(r["episodes_done"] for r in rows)
        term = [r.get("episode/rew_termination", float("nan")) for r in rows]
        if not all(math.isfinite(x) for x in term):
            fail(f"cassie's termination episode sum is not finite: {term}")
        if done == 0:
            log("cassie: no env terminated in these iterations")
        else:
            log(f"cassie: {done:g} episodes ended; termination episode sums {term}")
            if not any(x != 0.0 for x in term):
                fail("cassie's episodes ended with a zero termination sum")

    checks = {"anymal_c_rough_teacher": priv_critic, "anymal_c_student": priv_critic,
              "cassie": termination}
    for task in FAMILY_TRAIN:
        t0 = time.perf_counter()
        cfg, _ = task_registry.get_cfgs(task)
        robot, route = cfg.asset.name, ("fixed" if cfg.asset.fix_base_link else
                                        "B2" if cfg.terrain.mesh_type != "plane" else "B1")
        n = training_path(dev, task, 1, FAMILY_ITERS, envs=FLEET, check=checks.get(task))
        launches[(route, robot)] = launches.get((route, robot), 0) + n
        phase_done(f"{task} training path", t0)


def family_stepping(dev, launches):
    """Each FAMILY_STEP task through the registry at the fleet, FAMILY_STEPS
    control steps of random actions: its route exactly FAMILY_STEPS
    launches, the others 0, finite observations and rewards.  Adds the
    launches to ``launches[(route, robot)]``."""
    import torch

    from extended_legged_gym_tpu_torch.utils.task_registry import get_args, task_registry

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    for task in FAMILY_STEP:
        args = get_args(argv=["--task", task, "--num_envs", str(FLEET), "--device", str(dev)])
        env, _ = task_registry.make_env(task, args)
        route = route_of(env)
        with torch.no_grad():
            state = env.reset_all(seed=0)
            torch.cuda.synchronize()
            zero_launch_counts()
            rew = []
            for _ in range(FAMILY_STEPS):
                state = env.step(state, torch.randn(FLEET, env.num_actions, device=dev,
                                                    generator=gen))
                rew.append(state.rew)
            torch.cuda.synchronize()
        counts = launch_counts()
        rew = torch.stack(rew)
        others = {k: v for k, v in counts.items() if k != route}
        log(f"{task}: {FAMILY_STEPS} control steps at {FLEET} envs, obs {env.num_obs}, "
            f"commands {tuple(state.commands.shape)}: {route} launches={counts[route]}, others "
            f"{others}; reward mean {rew.mean().item():.4g}, resets "
            f"{int(state.reset_buf.sum())}")
        if counts[route] != FAMILY_STEPS or any(others.values()):
            fail(f"{task} launched {route} {counts[route]} times (want {FAMILY_STEPS}) and "
                 f"others {others}")
        if not bool(torch.isfinite(rew).all()) or not bool(torch.isfinite(state.obs).all()):
            fail(f"non-finite rewards or observations stepping {task}")
        key = (route, env.cfg.asset.name)
        launches[key] = launches.get(key, 0) + counts[route]
    phase_done("family stepping", t0)


def extensions_path(dev):
    """The RL extensions on anymal_c_flat at the fleet: recurrent PPO (an
    LSTM of 512 before each MLP) with RND for EXT_ITERS iterations (B1
    exactly EXT_ITERS x 24), its stateful inference policy and a save/load
    round trip; the recurrent policy with a symmetry_cfg is refused; then
    the MLP policy with RND and the left-right symmetry loss for EXT_ITERS
    iterations (B1 exactly EXT_ITERS x 24).  Returns B1's launches."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch import robots  # noqa: F401
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_symmetry_cfg
    from extended_legged_gym_tpu_torch.scripts.bench_train import RND_CFG, recurrent_train_cfg
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    t0 = time.perf_counter()
    cfg, _ = task_registry.get_cfgs("anymal_c_flat")
    cfg.env.num_envs, cfg.seed = FLEET, 2
    env, _ = task_registry.make_env("anymal_c_flat", env_cfg=cfg, device=dev)
    total = 0
    refused = False
    try:
        tc = recurrent_train_cfg(task_registry.get_cfgs("anymal_c_flat")[1])
        tc.algorithm.symmetry_cfg = anymal_c_symmetry_cfg()
        OnPolicyRunner(env, tc)
    except ValueError as e:
        refused = "symmetry" in str(e)
    log(f"recurrent policy with a symmetry_cfg refused: {refused}")
    if not refused:
        fail("the runner took symmetry_cfg with a recurrent policy")
    for name in ("recurrent + RND", "MLP + RND + symmetry"):
        tc = task_registry.get_cfgs("anymal_c_flat")[1]
        tc.seed = 2
        if name.startswith("recurrent"):
            recurrent_train_cfg(tc)
        else:
            tc.algorithm.rnd_cfg = dict(RND_CFG)
            tc.algorithm.symmetry_cfg = anymal_c_symmetry_cfg()
        with tempfile.TemporaryDirectory() as root:
            runner, _ = task_registry.make_alg_runner(env, train_cfg=tc, log_root=root)
            before = flat_params(runner.network.parameters())
            rnd_before = flat_params(runner.rnd.predictor.parameters())
            torch.cuda.synchronize()
            zero_launch_counts()
            runner.learn(EXT_ITERS, log_interval=1)
            torch.cuda.synchronize()
            counts = launch_counts()
            with open(os.path.join(runner.log_dir, "metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            want = EXT_ITERS * runner.num_steps_per_env
            log(f"{name} path: {env.num_envs} envs, policy {tc.runner.policy_class_name} "
                f"({tc.policy.rnn_type} {tc.policy.rnn_hidden_size} before "
                f"{tc.policy.actor_hidden_dims})" if runner.recurrent else
                f"{name} path: {env.num_envs} envs, policy {tc.runner.policy_class_name} "
                f"{tc.policy.actor_hidden_dims}, symmetry coef {runner.symmetry[2]}")
            log(f"  launches {counts} (want B1 {want}); losses "
                + " ".join(f"{r['loss']:.4g}" for r in rows) + "; rnd_loss "
                + " ".join(f"{r['rnd_loss']:.4g}" for r in rows) + "; nonfinite_skips "
                + " ".join(f"{r['nonfinite_skips']:g}" for r in rows) + "; iteration "
                + " ".join(f"{r['collection_s'] + r['update_s']:.3f} s = collection "
                           f"{r['collection_s']:.3f} + update {r['update_s']:.3f}" for r in rows))
            if counts["B1"] != want or counts["B2"] or counts["B1 torques-in"]:
                fail(f"the {name} path launched {counts} (want B1 {want} only)")
            if not all(math.isfinite(r["loss"]) and math.isfinite(r["rnd_loss"]) for r in rows):
                fail(f"non-finite loss or RND loss on the {name} path")
            if any(r["nonfinite_skips"] for r in rows):
                fail(f"the {name} path skipped updates for non-finite values")
            if torch.equal(before, flat_params(runner.network.parameters())) or torch.equal(
                    rnd_before, flat_params(runner.rnd.predictor.parameters())):
                fail(f"the {name} path left the policy or the RND predictor unchanged")
            total += counts["B1"]
            if runner.recurrent:
                obs = runner.env_state.obs
                policy = runner.get_inference_policy()
                a1, a2 = policy(obs), policy(obs)
                policy.reset(torch.ones(env.num_envs, dtype=torch.bool, device=dev))
                a3 = policy(obs)
                path = os.path.join(root, "roundtrip.pkl")
                runner.save(path)
                fresh = OnPolicyRunner(env, tc)
                fresh.load(path)
                a4 = fresh.get_inference_policy()(obs)
                log(f"  stateful inference policy: second call differs by "
                    f"{(a2 - a1).abs().max().item():.3g}, after reset equal {torch.equal(a1, a3)}; "
                    f"save/load round trip equal {torch.equal(a1, a4)}")
                if torch.equal(a1, a2) or not torch.equal(a1, a3) or not torch.equal(a1, a4):
                    fail("the recurrent inference policy does not carry, reset or round-trip")
    phase_done("RL extensions", t0)
    return total


def geom_positions(model, phys):
    """World positions [B, ng, 3] of the collision spheres of ``phys``."""
    from extended_legged_gym_tpu_torch.physics.dynamics import forward_kinematics
    from extended_legged_gym_tpu_torch.physics.engine import geom_positions as world

    return world(model, forward_kinematics(model, phys.base_pos, phys.base_quat, phys.joint_pos,
                                           phys.base_lin_vel, phys.base_ang_vel, phys.joint_vel))


def rows_on_cpu(n_check, *xs):
    """Every ``len // n_check``-th row of the [..., 3] tensors ``xs``
    (flattened) in float64 on the CPU, and the row selection."""
    import torch

    n = xs[0].reshape(-1, 3).shape[0]
    sel = torch.arange(0, n, max(1, n // n_check), device=xs[0].device)[:n_check]
    return sel, [x.reshape(-1, 3)[sel].double().cpu() for x in xs]


def flipped_only(a, b, atol):
    """Rows where ``a`` and ``b`` [N, 3] differ, and whether each such row is
    exactly ``b`` negated: the tie between a ground face and the ceiling
    face coincident with it, facing the other way (a barrier of zero gap),
    where either answer is right and float rounding picks one."""
    diff = (a - b).abs().amax(-1) > atol
    return diff, (a + b).abs().amax(-1) <= atol


def check_rays(mesh, origins, dirs, outs, n_check, max_distance):
    """The card's ray cast ``outs`` = (distance, hit, points, normal) against
    the float64 CPU ray cast on ``n_check`` of its rays: hits exactly,
    distances and points within RAY_ATOL, normals within RAY_ATOL except
    where coincident faces tie (``flipped_only``).  Returns the largest
    difference."""
    from extended_legged_gym_tpu_torch.perception.trimesh import raycast_trimesh

    sel, (o, d) = rows_on_cpu(n_check, origins, dirs)
    rd, rh, rp, rn = raycast_trimesh(mesh, o, d, max_distance)
    dist, hit, pts, nrm = (x.reshape((-1,) + x.shape[2:])[sel].cpu() for x in outs)
    bad_hits = int((hit != rh).sum())
    err = max((dist.double() - rd).abs().max().item(), (pts.double() - rp).abs().max().item())
    diff, neg = flipped_only(nrm.double(), rn, RAY_ATOL)
    log(f"raycast_trimesh: {len(sel)} rays held to the float64 CPU version: {bad_hits} hit flags "
        f"differ; distances and points within {err:.3g} (atol {RAY_ATOL}); {int(diff.sum())} "
        f"normals differ, {int((diff & neg).sum())} of them coincident faces' tie")
    if bad_hits or not err <= RAY_ATOL or bool((diff & ~neg).any()):
        fail("raycast_trimesh differs from its float64 CPU version")
    return err


def check_sdf(mesh, points, outs, n_check):
    """The card's mesh SDF ``outs`` = (sdf, gradient, nearest) against the
    float64 CPU version on ``n_check`` points.  Everywhere the distance's
    magnitude agrees within SDF_ATOL and the gradient is a unit vector
    within UNIT_ATOL (a longer one makes the contact damper indefinite).
    The sign, gradient and nearest point are the CPU's (within SDF_ATOL and
    SDF_DIR_ATOL) or another right answer:
    * where a ground face and a ceiling face coincide (a barrier of zero
      gap), the sign and the gradient exactly negated;
    * where float32 rounding chose another of the faces within 1e-4 m of the
      minimum: a nearest point on the mesh (|sdf| <= SDF_ATOL there on the
      CPU) at most 1e-4 + SDF_ATOL m farther than the minimum, and the
      gradient along the card's sign times u = point - nearest within
      SDF_DIR_ATOL + 1e-5 m / |u| (u carries the float32 rounding of the
      arena's coordinates, ~2e-6 m in each of its two ends).
    Any other point fails.  Returns the largest magnitude difference."""
    import torch

    from extended_legged_gym_tpu_torch.perception.trimesh import query_sdf_trimesh

    sel, (p,) = rows_on_cpu(n_check, points)
    rs, rg, rn = query_sdf_trimesh(mesh, p)
    sdf, grad, near = (x.reshape((-1,) + x.shape[2:])[sel].cpu().double() for x in outs)
    err = (sdf.abs() - rs.abs()).abs().max().item()
    unit = (grad.norm(dim=-1) - 1.0).abs().max().item()
    flip = (sdf - rs).abs() > SDF_ATOL
    gdiff, gneg = flipped_only(grad, rg, SDF_DIR_ATOL)
    same = ~flip & ~gdiff & ((near - rn).abs().amax(-1) <= SDF_DIR_ATOL)
    tie = flip & gneg
    u = p - near
    un = u.norm(dim=-1).clamp(min=1e-12)
    sgn = torch.where(sdf >= 0.0, 1.0, -1.0).double()
    along = ((grad - sgn[:, None] * u / un[:, None]).abs().amax(-1)
             <= SDF_DIR_ATOL + 1e-5 / un)
    other = (~flip & ~same & (query_sdf_trimesh(mesh, near)[0].abs() <= SDF_ATOL)
             & (un <= rs.abs() + 1e-4 + SDF_ATOL) & along)
    bad = ~(same | tie | other)
    log(f"query_sdf_trimesh: {len(sel)} points held to the float64 CPU version: magnitudes "
        f"within {err:.3g} (atol {SDF_ATOL}), gradients unit within {unit:.3g} (atol "
        f"{UNIT_ATOL}); {int(same.sum())} as on the CPU, {int(tie.sum())} coincident faces' "
        f"tie, {int(other.sum())} another face within 1e-4 m of the minimum "
        f"({int((other & (un < 1e-3)).sum())} of them within 1 mm of it), {int(bad.sum())} "
        f"wrong")
    if not err <= SDF_ATOL or not unit <= UNIT_ATOL or bool(bad.any()):
        fail("query_sdf_trimesh differs from its float64 CPU version")
    return err


def perception_path(dev, envs=CONFINED_RAY_ENVS, n_check=CONFINED_CHECK):
    """Phase 26: the confined arena of ``elair_barrier_nav`` (the task's
    published 3 x 3 grid of 6 m, 3 m border, its wall-corrected mesh); the
    mesh ray cast of ``envs`` sensors x 16 x 8 spherical rays (max 10 m)
    posed over the arena, and the mesh SDF of the nav rollout's collision
    spheres (4 mains x 128 samples, the joints perturbed); each timed, its
    peak memory printed, and held to its float64 CPU version."""
    import torch

    from extended_legged_gym_tpu_torch.envs.legged_robot_config import RaycasterCfg
    from extended_legged_gym_tpu_torch.perception.patterns import make_pattern
    from extended_legged_gym_tpu_torch.perception.trimesh import (query_sdf_trimesh,
                                                                   raycast_trimesh)
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import task_env
    from extended_legged_gym_tpu_torch.utils.math import quat_from_axis_angle, quat_rotate

    t0 = time.perf_counter()
    env = task_env("elair_barrier_nav", dev, 4)
    terrain, mesh = env.terrain, env.terrain.trimesh
    log(f"elair_barrier_nav arena: grid {terrain.shape[0]} x {terrain.shape[1]} at "
        f"{terrain.hscale:.3g} m, ceiling {terrain.has_ceiling}; mesh {mesh.num_triangles} "
        f"triangles in {mesh.nx} x {mesh.ny} cells of {mesh.cell_size:.3g} m, K = "
        f"{mesh.cell_tris.shape[1]}; built in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    H, W = terrain.shape
    lo = torch.tensor(terrain.origin, device=dev)
    span = torch.tensor([(H - 1) * terrain.hscale, (W - 1) * terrain.hscale], device=dev)
    xy = lo + span * torch.rand(envs, 2, device=dev, generator=gen)
    base = torch.cat([xy, 0.4 + 0.3 * torch.rand(envs, 1, device=dev, generator=gen)], 1)
    yaw = 2 * math.pi * torch.rand(envs, device=dev, generator=gen)
    quat = quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0], device=dev).expand(envs, 3), yaw)
    rc = RaycasterCfg()
    rc.ray_pattern, rc.spherical_num_azimuth, rc.spherical_num_elevation = "spherical", 16, 8
    pat = torch.as_tensor(make_pattern(rc), device=dev)
    off = torch.tensor(rc.offset_pos, device=dev)
    origins = base[:, None] + quat_rotate(quat[:, None], off.expand(pat.shape))
    dirs = quat_rotate(quat[:, None], pat[None].expand(envs, -1, -1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dist, hit, pts, nrm = raycast_trimesh(mesh, origins, dirs, rc.max_distance)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
    ms = bench_mpc.cuda_ms(lambda: raycast_trimesh(mesh, origins, dirs, rc.max_distance),
                           reps=2)
    log(f"raycast_trimesh {envs} x {pat.shape[0]} rays: {ms:.2f} ms per call, peak "
        f"{peak:.0f} MiB above the inputs; {hit.float().mean().item():.3f} hit")
    ray_err = check_rays(mesh, origins, dirs, (dist, hit, pts, nrm), n_check, rc.max_distance)

    # the collision spheres of the nav rollout batch
    state = env.reset_all(seed=0)
    S = env.cfg.trajectory_opt.num_samples + 1
    rep = lambda x: x.repeat_interleave(S, dim=0)
    phys = state.phys.replace(**{k: rep(getattr(state.phys, k)) for k in
                                 ("base_pos", "base_quat", "joint_pos", "base_lin_vel",
                                  "base_ang_vel", "joint_vel")})
    phys = phys.replace(
        joint_pos=phys.joint_pos + 0.3 * torch.randn(phys.joint_pos.shape, device=dev,
                                                     generator=gen),
        base_pos=phys.base_pos + torch.cat([0.3 * torch.randn(phys.base_pos.shape[0], 2, device=dev,
                                                              generator=gen),
                                            -0.25 * torch.rand(phys.base_pos.shape[0], 1,
                                                               device=dev, generator=gen)], 1))
    gp = geom_positions(env.model, phys)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sdf, grad, near = query_sdf_trimesh(mesh, gp)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
    ms_sdf = bench_mpc.cuda_ms(lambda: query_sdf_trimesh(mesh, gp), reps=5)
    log(f"query_sdf_trimesh at the nav rollout's {gp.shape[0]} x {gp.shape[1]} spheres: "
        f"{ms_sdf:.2f} ms per call, peak {peak:.0f} MiB above the inputs; "
        f"{int((sdf < mesh.sdf_radius).sum())} within the SDF radius, "
        f"{int((sdf < 0).sum())} inside")
    sdf_err = check_sdf(mesh, gp, (sdf, grad, near), n_check)
    phase_done("confined perception", t0)
    return dict(ray_ms=ms, sdf_ms=ms_sdf, ray_err=ray_err, sdf_err=sdf_err)


class StepCounter:
    """Counts ``env.rollout_step`` calls (each is one control step of the
    rollout batch) and the non-finite rewards they return."""

    def __init__(self, env):
        import torch

        self.n, self.nonfinite, step = 0, 0, env.rollout_step

        def counted(*a, **kw):
            self.n += 1
            rs, rew = step(*a, **kw)
            self.nonfinite += int((~torch.isfinite(rew)).sum())
            return rs, rew
        env.rollout_step = counted


def profiled(fn):
    """``fn()`` under torch.profiler: (result, wall ms, device-busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from extended_legged_gym_tpu_torch.scripts import bench_mpc

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, wall, bench_mpc.device_split(prof, 1)["device_busy_ms"]


def mpc_cycle(dev, task, route, num_envs=4, profile=True, n_diffuse=None):
    """One mpc_step of ``task`` at ``num_envs`` main envs (default 4: the
    nav tasks' published width, 4 mains x 128 samples, H = 16), timed, with
    ``n_diffuse`` diffusion steps (default: the config's).
    ``route`` "engine" must advance ``EngineEnvStep.engine_substeps`` by
    exactly (control steps) x decimation and launch no kernel; a kernel
    route exactly one launch per control step (the rollout batches' and the
    main step's), the others none; "none" (the kinematic planners) nothing.
    Then, where ``profile``, one control step of the rollout batch under the
    profiler for the device's idle share (a whole cycle's trace is too long
    to reduce here).  Returns ``(launches of route or engine substeps, cycle
    ms)``."""
    import torch

    from extended_legged_gym_tpu_torch.physics.engine import EngineEnvStep
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import task_env
    from extended_legged_gym_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    env = task_env(task, dev, num_envs)
    to = env.cfg.trajectory_opt
    actual = ("engine" if env.engine_step is not None else
              "none" if type(env).__name__ == "RobotPlanGradSampling" else route_of(env))
    if actual != route:
        fail(f"{task} takes the {actual} route, not {route}")
    counter = StepCounter(env)
    state = env.reset_all(seed=0)
    nodes = torch.zeros(env.num_envs, to.horizon_nodes + 1, env.num_actions, device=dev)
    torch.cuda.synchronize()
    zero_launch_counts()
    EngineEnvStep.engine_substeps = 0
    with torch.no_grad():
        t1 = time.perf_counter()
        state, nodes, _ = env.mpc_step(state, nodes, n_diffuse=n_diffuse)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
    counts = launch_counts()
    n_roll = counter.n
    steps = n_roll + 1
    decim = env.cfg.control.decimation
    engine = EngineEnvStep.engine_substeps
    want_engine = steps * decim if route == "engine" else 0
    want = {k: (steps if k == route else 0) for k in counts}
    idle = ""
    if route != "none" and profile:
        S = to.num_samples + 1
        rs = tree_map(lambda x: x.repeat_interleave(S, dim=0), env.main_to_rollout(state))
        ep = tree_map(lambda x: x.repeat_interleave(S, dim=0), state.env_params)
        act = torch.zeros(rs.phys.base_pos.shape[0], env.num_actions, device=dev)
        with torch.no_grad():
            _, step_ms, busy = profiled(lambda: env.rollout_step(rs, act, ep))
        idle = (f"; one rollout control step of {rs.phys.base_pos.shape[0]} envs profiled: "
                f"{step_ms:.1f} ms, device busy {busy:.1f} ms, idle {1 - busy / step_ms:.1%}")
    log(f"{task} mpc_step (E={env.num_envs}, S={to.num_samples + 1}, H={to.horizon_samples}, "
        f"{n_diffuse or to.num_diffuse_steps} diffusion steps, polish {to.polish_iters}): "
        f"{wall:.1f} ms; "
        f"{n_roll} rollout control steps ({counter.nonfinite} non-finite rollout rewards); "
        f"launches {counts}, engine substeps {engine} (want {want_engine}); rewards finite "
        f"{bool(torch.isfinite(state.rew).all())}" + idle)
    if counts != want or engine != want_engine:
        fail(f"{task}: launches {counts} and engine substeps {engine}, want {want} and "
             f"{want_engine}")
    if not all(torch.isfinite(getattr(state.phys, k)).all() for k in ONE_STEP_ATOL
               if k != "foot_pos"):
        fail(f"non-finite main-env state on {task}'s MPC path")
    if counter.nonfinite or not (torch.isfinite(state.obs).all() and torch.isfinite(nodes).all()
                                 and torch.isfinite(state.rew).all()):
        bad_obs = (~torch.isfinite(state.obs)).any(0).nonzero().flatten().tolist()
        log(f"{task}: non-finite rewards in envs "
            f"{(~torch.isfinite(state.rew)).nonzero().flatten().tolist()}, observation columns "
            f"{bad_obs[:16]}, plan entries {int((~torch.isfinite(nodes)).sum())}; episode sums "
            + " ".join(f"{k}={v.tolist()}" for k, v in state.episode_sums.items()))
        fail(f"non-finite rollout rewards ({counter.nonfinite}), main-env rewards, "
             f"observations or plans on {task}'s MPC path")
    phase_done(f"{task} mpc_step", t0)
    return (engine if route == "engine" else counts.get(route, 0)), wall


def engine_vs_cpu(dev, B=NAV_B, n_cpu=ENGINE_CPU_B):
    """The engine route on the card against the CPU: ``B`` envs of
    ``elair_barrier_nav`` (the main envs' standing states, the joints and
    base perturbed, on the arena's mesh contacts) take one control step
    (4 engine substeps, PD torques) on the card; the first ``n_cpu`` take
    the same step on the CPU in float64 (an env whose CPU float32 and
    float64 steps part beyond ONE_STEP_ATOL, a contact decision that
    rounding flips, is held to the CPU float32 step).  Fails beyond
    ONE_STEP_ATOL.  Returns the card's ms per control step."""
    import torch

    from extended_legged_gym_tpu_torch.physics.engine import EnvPhysParams
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import STAND_HEIGHT, task_env
    from extended_legged_gym_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()
    env = task_env("elair_barrier_nav", dev, 4)
    cpu = task_env("elair_barrier_nav", "cpu", 4)
    state = env.reset_all(seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    S = B // env.num_envs
    phys = tree_map(lambda x: x.repeat_interleave(S, dim=0), state.phys)
    # standing 1 cm low on the spawn floor (z = 0), some up to 0.6 m
    # toward the first barrier (its face 0.5 m past the spawn box)
    shift = torch.zeros(B, 3, device=dev)
    shift[:, 0] = 0.6 * torch.rand(B, device=dev, generator=gen)
    shift[:, 2] = STAND_HEIGHT["elspider_air"] - 0.01 - phys.base_pos[:, 2]
    phys = phys.replace(joint_pos=phys.joint_pos + 0.2 * torch.randn(
        phys.joint_pos.shape, device=dev, generator=gen), base_pos=phys.base_pos + shift)
    ep = tree_map(lambda x: x.repeat_interleave(S, dim=0), state.env_params)
    act = torch.randn(B, env.num_actions, device=dev, generator=gen)
    last = torch.zeros(B, env.num_dof, device=dev)
    with torch.no_grad():
        out = env._physics_substeps(phys, act, ep, last)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        env._physics_substeps(phys, act, ep, last)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
    sl = lambda x: x[:n_cpu].cpu()
    res = {}
    for dt in (torch.float32, torch.float64):
        c = lambda x: sl(x).to(dt) if x.is_floating_point() else sl(x)
        p = tree_map(c, phys)
        res[dt] = cpu._physics_substeps(p, c(act), EnvPhysParams(c(ep.friction_scale),
                                                                 c(ep.base_mass_delta)),
                                        c(last))
    env_err = lambda a, b: (a.double() - b.double()).abs().reshape(n_cpu, -1).amax(1)
    parted = torch.zeros(n_cpu, dtype=torch.bool)
    for k, tol in ONE_STEP_ATOL.items():
        if k != "foot_pos":
            parted |= env_err(getattr(res[torch.float32][0], k), getattr(res[torch.float64][0], k)) > tol
    errs = {}
    for k in ONE_STEP_ATOL:
        if k == "foot_pos":
            continue
        card = getattr(out[0], k)[:n_cpu].cpu().double()
        ref = torch.where(parted.reshape((-1,) + (1,) * (card.dim() - 1)),
                          getattr(res[torch.float32][0], k).double(),
                          getattr(res[torch.float64][0], k))
        errs[k] = (card - ref).abs().max().item()
    touching = int((out[2].geom_forces[:n_cpu].norm(dim=-1) > 1.0).sum())
    log(f"engine route ({B} envs on elair_barrier_nav's mesh contacts): {ms:.1f} ms per control "
        f"step on the card; the first {n_cpu} held to the CPU (float64; {int(parted.sum())} "
        f"parted from float32 and held to it), {touching} spheres touching: "
        + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
    for k, v in errs.items():
        if not v <= ONE_STEP_ATOL[k]:
            fail(f"the engine route on the card differs from the CPU: {k} by {v:.3g}")
    if touching == 0:
        fail("no sphere touched the mesh in the engine-route check")
    phase_done("engine route vs CPU", t0)
    return ms


def new_kernels(dev, stats):
    """Each new (regime, tables, batch) pair of this slice's MPC tasks
    against its plain version at NAV_B (4 mains x 128 samples; B2 on
    ``anymal_c_nav_barrier``'s own grid above its spawn origins; float64
    plain for the hexapod's light legs).  Returns the largest difference of
    each pair."""
    import torch

    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, near_standing,
                                                                    task_env)

    t0 = time.perf_counter()
    errs = {}
    for route, task in NEW_KERNELS:
        env = task_env(task, dev, NAV_B)
        step = env.decimated_step
        robot = os.path.splitext(os.path.basename(env.cfg.asset.file))[0]
        if route_of(env) != route:
            fail(f"{task}'s physics step is not {route}")
        origins = env.reset_all(seed=0).env_origins if env.custom_origins else None
        states = near_standing(step.model, NAV_B, NAV_B, dev, origins, STAND_HEIGHT[robot])
        stats[(route, robot, NAV_B)] = {}
        errs[(route, robot, NAV_B)] = compare_one_step(
            f"{route} {robot} ({task})", step, NAV_B, states, stats[(route, robot, NAV_B)],
            torch.float64 if robot == "elspider_air" else None)
    phase_done("new kernel batches vs plain", t0)
    return errs


def stones_check(runner, rows):
    """After training with stones: the active stones have left their spawn
    heights (0.3-1.0 m above the base) for the ground; a stone planted 2 cm
    into env 0's base sphere pushes the base and takes the reaction."""
    import torch

    env, state = runner.env, runner.env_state
    st = state.stones
    z = st.pos[..., 2][st.active]
    log(f"stones: {int(st.active.sum())} active in {env.num_envs} envs, height median "
        f"{z.median().item():.3f} m, speed max {st.vel.norm(dim=-1).max().item():.3f} m/s")
    if not z.median().item() < 0.3 or not torch.isfinite(st.pos).all():
        fail("the stones did not fall to the ground")
    base = state.phys.base_pos[0]
    up = float(env._obstacle_sphere_radius[0] + st.radius[0, 0]) - 0.02
    st = st.replace(pos=st.pos.clone(), vel=st.vel.clone(), active=st.active.clone())
    st.pos[0, 0] = base + torch.tensor([0.0, 0.0, up], device=base.device)
    st.vel[0, 0] = 0.0
    st.active[0, 0] = True
    with torch.no_grad():
        nxt = env.step(state.replace(stones=st),
                       torch.zeros(env.num_envs, env.num_actions, device=base.device))
    f_base = nxt.geom_forces[0, env._base_geom].norm().item()
    v_stone = nxt.stones.vel[0, 0].norm().item()
    log(f"a stone planted 2 cm into env 0's base: base force {f_base:.2f} N, the stone's "
        f"speed after the step {v_stone:.3f} m/s")
    if not (f_base > 1.0 and v_stone > 0.0):
        fail("the planted stone and the base exchanged no force")


def new_training(dev, launches):
    """NEW_ITERS PPO iterations at the fleet of each NEW_TRAIN task through
    the registry (training_path: its route exactly NEW_ITERS x 24, the
    others 0), then one more iteration under the profiler for the device's
    idle share; the stones checked on ``anymal_c_flat_obstacles``.  Adds the
    launches to ``launches[(route, robot)]``."""
    from extended_legged_gym_tpu_torch.scripts.bench_train import ppo_iteration

    for task, route in NEW_TRAIN:
        t0 = time.perf_counter()
        n = training_path(dev, task, 1, NEW_ITERS, check=stones_check
                          if task == "anymal_c_flat_obstacles" else None)
        robot = "elspider_air" if "elspider" in task else "anymal_c"
        launches[(route, robot)] = launches.get((route, robot), 0) + n
        iterate, _, _ = ppo_iteration(task, 1, dev)
        iterate()
        times, wall, busy = profiled(iterate)
        log(f"{task}: one profiled iteration {wall:.1f} ms (collection "
            f"{times['collection_s']:.3f} s + update {times['update_s']:.3f} s), device busy "
            f"{busy:.1f} ms, idle {1 - busy / wall:.1%}")
        phase_done(f"{task} training path", t0)


def robot_of(cfg):
    """The robot of a task config: its model file's name (anymal_c,
    elspider_air, ...)."""
    return os.path.splitext(os.path.basename(cfg.asset.file))[0]


def polish_modes(dev):
    """One E=1 flagship solve per POLISH_MODES mode at POLISH_ITERS polish
    iterations (scripts/bench_polish): the counts of B1 launches and engine
    substeps exactly expected_counts', B2 0; each env's fast-route score of
    the polished nodes not below that of the same solve's diffused nodes
    (the solve rerun with the polish off, the same noise); the solve's ms.
    Returns the B1 launches of the counted solves."""
    import torch

    from extended_legged_gym_tpu_torch.scripts.bench_polish import (counted_solve,
                                                                    expected_counts, node_scores,
                                                                    polish_env)

    t0 = time.perf_counter()
    launches = 0
    for mode in POLISH_MODES:
        env = polish_env(mode, POLISH_ITERS, dev)
        to = env.cfg.trajectory_opt
        state = env.reset_all(seed=0)
        nodes = env.traj_sampler.init_node_trajectories()
        with torch.no_grad():
            iters, to.polish_iters = to.polish_iters, 0
            diffused, _, _ = counted_solve(env, state, nodes, seed=1)
            to.polish_iters = iters
            t1 = time.perf_counter()
            out, info, counts = counted_solve(env, state, nodes, seed=1)
            ms = (time.perf_counter() - t1) * 1e3
            before, after = node_scores(env, state, diffused), node_scores(env, state, out)
        want = dict(zip(("B1", "engine_substeps"), expected_counts(env)), B2=0)
        gains = {k: [round(float(x), 6) for x in v.reshape(-1)] for k, v in info.items()
                 if k in ("polish_gain", "ilqr_accept")}
        log(f"polish {mode} x{to.polish_iters} (E=1, Nsample={to.num_samples + 1}, "
            f"Hsample={to.horizon_samples}, Hnode={to.horizon_nodes}, "
            f"Ndiffuse={to.num_diffuse_steps}): {ms:.1f} ms; counts {counts} (want {want}); "
            f"score diffused {before.tolist()} -> polished {after.tolist()}; {gains}")
        launches += counts["B1"]
        if counts != want:
            fail(f"polish {mode}: counts {counts}, want {want}")
        if not bool((after >= before - 1e-5 * before.abs() - 1e-6).all()):
            fail(f"polish {mode} lowered a score: {before.tolist()} -> {after.tolist()}")
        if not bool(torch.isfinite(out).all()):
            fail(f"polish {mode}: non-finite nodes")
    phase_done("polish modes", t0)
    return launches


def gradients_on_card(dev):
    """The differentiable route on the card against the float64 plain engine
    on the CPU, at E=1 from the flagship env's reset state (GRAD_HS + 1
    dense steps, GRAD_HN + 1 seeded nodes): the gradient of the summed
    reward with respect to the nodes, and fx, fu of the first control step
    (the iLQR's forward-mode linearization).  Each is held to the float64
    result within GRAD_TOL_FACTOR x the CPU float32 result's distance from
    it, plus 1e-6 of its largest entry; the tolerance is printed."""
    import torch

    from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (
        AnymalCTrajGradSampling, anymal_c_traj_sampling_cfg)
    from extended_legged_gym_tpu_torch.trajopt import riccati
    from extended_legged_gym_tpu_torch.utils.tree import tree_map

    t0 = time.perf_counter()

    def make(device):
        cfg = anymal_c_traj_sampling_cfg(1)
        cfg.trajectory_opt.horizon_samples, cfg.trajectory_opt.horizon_nodes = GRAD_HS, GRAD_HN
        return AnymalCTrajGradSampling(cfg, device=device)

    env, cpu = make(dev), make("cpu")
    state = env.reset_all(seed=0)
    s32 = tree_map(lambda x: x.cpu(), state)
    s64 = tree_map(lambda x: x.double() if x.is_floating_point() else x, s32)
    gen = torch.Generator().manual_seed(0)
    nodes = 0.3 * torch.randn(1, GRAD_HN + 1, env.num_actions, generator=gen)

    def dense(e, n):
        return torch.einsum("dn,...na->...da", e.traj_sampler.spline.A.to(n.dtype), n)

    def grad(e, s, n):
        n = n.clone().requires_grad_(True)
        J = e.rollout_batch(s, dense(e, n)[:, None], differentiable=True)[:, 0].sum()
        return torch.autograd.grad(J, n)[0]

    def jac(e, s, n):
        step_fn, x0, ctx = e.ilqr_problem(s)
        us = dense(e, n.to(x0.dtype))[:, :1]
        with torch.no_grad():
            xs = x0[:, None].expand(-1, 2, -1)          # the step from x0 (its end unread)
            fx, fu = riccati._linearize(step_fn, xs, us, "proximal", 0.1, 1.0, ctx)[:2]
        return fx, fu

    res = {}
    for name, fn, what in (("node gradient", lambda e, s, n: (grad(e, s, n),),
                            f"{GRAD_HS + 1} control steps"),
                           ("fx, fu", jac, "the first control step")):
        card = [x.cpu().double() for x in fn(env, state, nodes.to(dev))]
        torch.cuda.synchronize()
        f32 = [x.double() for x in fn(cpu, s32, nodes)]
        f64 = fn(cpu, s64, nodes.double())
        for i, (c, a, b) in enumerate(zip(card, f32, f64)):
            label = name if len(card) == 1 else name.split(", ")[i]
            gap = (a - b).abs().max().item()
            tol = GRAD_TOL_FACTOR * gap + 1e-6 * b.abs().max().item()
            err = (c - b).abs().max().item()
            res[label] = err
            log(f"{label} on the card (E=1, {what}, shape {tuple(c.shape)}): "
                f"card - float64 CPU {err:.3g}, float32 CPU - float64 CPU {gap:.3g}, tolerance "
                f"{tol:.3g} ({GRAD_TOL_FACTOR:g} x the gap + 1e-6 x max |entry| "
                f"{b.abs().max().item():.3g})")
            if not (torch.isfinite(c).all() and err <= tol):
                fail(f"{label} on the card differs from the float64 CPU by {err:.3g} > {tol:.3g}")
    phase_done("gradients on the card", t0)
    return res


def new_tasks_14(dev, launches):
    """The 17 tasks of the last slice through the registry (phase 31).
    Adds each kernel launch to ``launches[(route, robot)]``."""
    import torch

    from extended_legged_gym_tpu_torch.physics.engine import EngineEnvStep
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import task_env
    from extended_legged_gym_tpu_torch.utils.task_registry import task_registry

    for task, route in NEW_MPC:
        mains = task_registry.get_cfgs(task)[0].env.num_envs
        n, _ = mpc_cycle(dev, task, route, num_envs=mains, profile=False)
        key = (route, robot_of(task_registry.get_cfgs(task)[0]))
        launches[key] = launches.get(key, 0) + n

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    for task, route in NEW_ROLLOUT:
        env = task_env(task, dev, task_registry.get_cfgs(task)[0].env.num_envs)
        if route_of(env) != route:
            fail(f"{task} takes the {route_of(env)} route, not {route}")
        # the ElSpider tasks register the plain ElSpider env, as the JAX
        # package does: no rollout_batch, so two steps instead
        E, H1, rollout = env.num_envs, 17, hasattr(env, "rollout_batch")
        with torch.no_grad():
            state = env.reset_all(seed=0)
            us = 0.3 * torch.randn(E, ROLLOUT_S, H1, env.num_actions, device=dev, generator=gen)
            torch.cuda.synchronize()
            zero_launch_counts()
            t1 = time.perf_counter()
            rew = env.rollout_batch(state, us) if rollout else state.rew
            for _ in range(1 if rollout else 2):
                state = env.step(state, torch.randn(E, env.num_actions, device=dev, generator=gen))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        counts = launch_counts()
        want = {k: ((H1 + 1 if rollout else 2) if k == route else 0) for k in counts}
        log(f"{task}: " + (f"rollout_batch {E} x {ROLLOUT_S} x H={H1 - 1} and one step"
                           if rollout else f"no rollout_batch ({type(env).__name__}); 2 steps at "
                           f"{E} envs") + f", {ms:.1f} ms: launches {counts}; rollout reward mean "
            f"{rew.mean().item():.4g}, step rewards finite {bool(torch.isfinite(state.rew).all())}")
        if counts != want:
            fail(f"{task}: launches {counts}, want {want}")
        if not (torch.isfinite(rew).all() and torch.isfinite(state.rew).all()
                and torch.isfinite(state.obs).all()):
            fail(f"non-finite rewards or observations on {task}")
        key = (route, robot_of(env.cfg))
        launches[key] = launches.get(key, 0) + counts[route]
    phase_done("batch-rollout tasks", t0)

    t0 = time.perf_counter()
    for task in POSE_TASKS:
        env = task_env(task, dev, task_registry.get_cfgs(task)[0].env.num_envs)
        with torch.no_grad():
            state = env.reset_all(seed=0)
            torch.cuda.synchronize()
            zero_launch_counts()
            EngineEnvStep.engine_substeps = 0
            t1 = time.perf_counter()
            rew = []
            for _ in range(POSE_STEPS):
                state = env.step(state, torch.randn(env.num_envs, 6, device=dev, generator=gen))
                rew.append(state.rew)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3 / POSE_STEPS
        rew = torch.stack(rew)
        counts = launch_counts()
        log(f"{task}: {POSE_STEPS} steps at {env.num_envs} envs ({env.num_rays} rays, "
            f"{len(env.geom_radius)} spheres, mesh contacts {env.terrain.contact_trimesh}), "
            f"{ms:.1f} ms per step: reward mean {rew.mean().item():.4g}, resets "
            f"{int(state.reset_buf.sum())}; launches {counts}, engine substeps "
            f"{EngineEnvStep.engine_substeps}")
        if any(counts.values()) or EngineEnvStep.engine_substeps:
            fail(f"{task} launched a kernel or the engine")
        if not (torch.isfinite(rew).all() and torch.isfinite(state.obs).all()):
            fail(f"non-finite rewards or observations on {task}")
    phase_done("pose-adapt tasks", t0)


def new_pairs_14(dev, stats):
    """Each PAIRS_14 (route, task, batch) against the float64 plain step
    (compare_one_step) and two launches bit for bit.  Returns the largest
    difference of each, keyed (route, robot, batch)."""
    import torch

    from extended_legged_gym_tpu_torch.scripts.bench_kernel import (STAND_HEIGHT, near_standing,
                                                                    task_env)

    t0 = time.perf_counter()
    errs = {}
    for route, task, B in PAIRS_14:
        env = task_env(task, dev, B)
        step, robot = env.decimated_step, robot_of(env.cfg)
        if route_of(env) != route:
            fail(f"{task}'s physics step is not {route}")
        origins = env.reset_all(seed=0).env_origins if env.custom_origins else None
        states = lambda seed: near_standing(step.model, B, seed, dev, origins, STAND_HEIGHT[robot])
        name = f"{route} {robot} ({task})"
        stats[(route, robot, B)] = {}
        errs[(route, robot, B)] = compare_one_step(name, step, B, states(B), stats[(route, robot, B)],
                                                   torch.float64)
        bit_identical(name, step, B, states(3))
    phase_done("new kernel pairs vs plain", t0)
    return errs


def play_path(dev, stats):
    """Phase 33: scripts/play on anymal_c_flat from the committed checkpoint
    into a temporary directory: exactly PLAY_STEPS B1 launches at PLAY_B,
    the first launch held to the plain step, every observation and action
    finite, the files written; ms per control step and the device's idle
    share over 25 more control steps.  Returns (launches, max difference,
    the play's output)."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch.scripts.play import play
    from extended_legged_gym_tpu_torch.utils.task_registry import get_args

    t0 = time.perf_counter()
    args = get_args(argv=["--task", "anymal_c_flat", "--load_run", PLAY_RUN, "--device", str(dev)])
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        zero_launch_counts()
        out = play(args, out_dir=d, log_root=os.path.join(ROOT, "logs"))
        torch.cuda.synchronize()
        counts = launch_counts()
        names = sorted(os.listdir(d))
    env, want = out["env"], {k: (PLAY_STEPS if k == "B1" else 0) for k in launch_counts()}
    log(f"play: {len(out['rows'])} control steps at {env.num_envs} envs, "
        f"{out['ms_per_step']:.3f} ms per control step (policy and logging included); "
        f"launches {counts}; files {names}; observations and actions finite {out['finite']}; "
        f"mean |vx - cmd| {out['mean_abs_vx_err']:.4f}")
    if counts != want or env.num_envs != PLAY_B:
        fail(f"play: {env.num_envs} envs, launches {counts}, want {PLAY_B} envs and {want}")
    if not out["finite"] or not math.isfinite(out["mean_abs_vx_err"]):
        fail("play: non-finite observations, actions or tracking")
    if not {"play_log.jsonl", "play_states.json"} <= set(names):
        fail(f"play wrote {names}")
    err = compare_one_step("B1 play", env.decimated_step, PLAY_B, out["first"], stats)
    policy = out["runner"].get_inference_policy()
    with torch.no_grad():
        state = env.reset_all(seed=1)

        def steps():
            nonlocal state
            for _ in range(25):
                state = env.step(state, policy(state.obs))
        _, wall, busy = profiled(steps)
    log(f"play's env at {PLAY_B} envs, 25 control steps profiled: {wall / 25:.3f} ms per step, "
        f"device busy {busy / 25:.3f} ms per step, idle share {1.0 - busy / wall:.3f}")
    phase_done("play", t0)
    return counts["B1"], err, out


def export_path(dev, out):
    """Phase 34: runner.export_policy of the play's runner into a temporary
    directory; policy_1.pt and policy.pt2 loaded on the card and held to the
    runner's inference policy on PLAY_B observations within EXPORT_ATOL (TF32
    off); an LSTM policy_lstm_1.pt of a freshly made recurrent runner held to
    RecurrentInferencePolicy over 5 steps, a reset_memory() and one more
    step."""
    import tempfile

    import torch

    from extended_legged_gym_tpu_torch.models.networks import RecurrentInferencePolicy
    from extended_legged_gym_tpu_torch.rl.runner import OnPolicyRunner
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_ppo_cfg
    from extended_legged_gym_tpu_torch.utils.export import load_pt2_policy

    t0 = time.perf_counter()
    env, runner = out["env"], out["runner"]
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for matmuls")
    with torch.no_grad():
        obs = env.reset_all(seed=2).obs
        want = runner.get_inference_policy()(obs)
        with tempfile.TemporaryDirectory() as d:
            files = runner.export_policy(d)
            names = [os.path.basename(f) for f in files]
            got = {"policy_1.pt": torch.jit.load(files[0], map_location=dev)(obs),
                   "policy.pt2": load_pt2_policy(files[1], dev)(obs)}
            tc = anymal_c_ppo_cfg()
            tc.runner.policy_class_name = "ActorCriticRecurrent"
            rec = OnPolicyRunner(env, tc)
            lstm_file = rec.export_policy(d)[0]
            lstm = torch.jit.load(lstm_file, map_location=dev)
        ref = RecurrentInferencePolicy(rec.network, rec.obs_norm, 1)
        lstm_err = 0.0
        for t in range(6):
            if t == 5:
                lstm.reset_memory()
                ref.reset(torch.ones(1, dtype=torch.bool, device=dev))
            x = obs[t:t + 1]
            lstm_err = max(lstm_err, (lstm(x) - ref(x)).abs().max().item())
    errs = {k: (v - want).abs().max().item() for k, v in got.items()}
    log(f"export: {names} and {os.path.basename(lstm_file)}; largest difference from the "
        f"runner's policy on {obs.shape[0]} observations: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items())
        + f"; the LSTM file against RecurrentInferencePolicy over 5 steps and a reset: "
        f"{lstm_err:.3g} (tolerance {EXPORT_ATOL:g})")
    if names != ["policy_1.pt", "policy.pt2"] or os.path.basename(lstm_file) != "policy_lstm_1.pt":
        fail(f"export wrote {names} and {lstm_file}")
    if not max(*errs.values(), lstm_err) <= EXPORT_ATOL:
        fail(f"an exported policy differs from the runner's by more than {EXPORT_ATOL:g}")
    phase_done("export", t0)


def nccl_path(dev):
    """Phase 35: init_multi_host at world size 1 on a free local port (the
    nccl backend), one all_reduce that returns its input, shard_batch and
    replicate of a tree on the card.  Returns the mesh (the group stays up
    for phase 36's data-parallel iteration and phase 37's weak-scaling
    row)."""
    import socket

    import torch
    import torch.distributed as dist

    from extended_legged_gym_tpu_torch.parallel.distributed import init_multi_host
    from extended_legged_gym_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    info = init_multi_host(f"127.0.0.1:{port}", 1, 0, device=dev)
    x = torch.arange(12.0, device=dev).reshape(4, 3)
    y = x.clone()
    dist.all_reduce(y)
    mesh = make_mesh(1, device=dev)
    tree = {"x": x, "step": (torch.ones(2, device=dev),)}
    sh, rp = shard_batch(tree, mesh, 4), replicate(tree, mesh)
    torch.cuda.synchronize()
    ok = (torch.equal(x, y) and torch.equal(sh["x"], x) and torch.equal(rp["x"], x)
          and torch.equal(rp["step"][0], tree["step"][0]))
    log(f"nccl: backend {dist.get_backend()}, {info}; all_reduce, shard_batch and replicate "
        f"{'return their input' if ok else 'DIFFER'}")
    if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo") or (
            info["process_count"] != 1 or not ok):
        fail("the world-size-1 nccl group misbehaves")
    phase_done("nccl", t0)
    return mesh


def dp_path(dev, mesh):
    """Phase 36: data-parallel PPO (the module docstring).  Returns B1's
    launches: the mesh's iteration, and each gloo rank's training and
    sharded optimize."""
    import torch

    from extended_legged_gym_tpu_torch.scripts import dryrun_multichip as dr

    t0 = time.perf_counter()
    # (b)'s processes start first: they reach the card while (a) runs
    procs = dr.launch(["--device", "cuda:0", "--backend", "gloo", "--passes", "train",
                       "toy_mpc"], 2)
    try:
        plain, dp = (dr.training_runner(m, FLEET, 24, device=dev) for m in (None, mesh))
        want = {k: (24 if k == "B1" else 0) for k in launch_counts()}
        counts = []
        for runner in (plain, dp):
            torch.cuda.synchronize()
            zero_launch_counts()
            metrics = runner.train_iteration()
            torch.cuda.synchronize()
            counts.append(launch_counts())
        same = dr.digest(dr.runner_tensors(plain)) == dr.digest(dr.runner_tensors(dp))
        log(f"dp (a): {FLEET} envs, one iteration with the world-size-1 nccl mesh beside one "
            f"without: parameters, normalizer and learning rate "
            f"{'bit for bit' if same else 'DIFFER'}; launches {counts[1]} (without the mesh "
            f"{counts[0]}); loss {float(metrics['loss']):.5g}")
        if not same:
            fail("the world-size-1 mesh's iteration differs from the one without a mesh")
        if counts != [want, want]:
            fail(f"the dp iterations launched {counts}, not {want} each")
        del plain, dp
    except BaseException:
        dr.stop(procs)
        raise
    outs = dr.collect(procs, DP_TIMEOUT_S)
    res = {r["pass"]: r for r in dr.results_of(outs[0])}
    train, mpc = res.get("train"), res.get("toy_mpc")
    log(f"dp (b): 2 gloo processes on the card, {time.perf_counter() - t0:.1f} s from their "
        f"start: {train}; {mpc}")
    if train is None or mpc is None:
        fail(f"the gloo ranks printed no result:\n{outs[0][-3000:]}")
    if not (train["agree"] and train["finite"]) or train["launches"] != [24, 24]:
        fail(f"the gloo ranks' training disagrees or launched B1 {train['launches']}, not 24 each")
    if not (mpc["agree"] and mpc["max_abs_err"] <= mpc["tolerance"] and min(mpc["launches"]) > 0):
        fail("the sample-sharded optimize disagrees across ranks or with the one-process one")
    phase_done("data-parallel PPO", t0)
    return counts[1]["B1"] + sum(train["launches"]) + sum(mpc["launches"])


def sweep_path(dev, mesh, stats):
    """Phase 37: scripts/weak_scaling's saturation sweep at SWEEP_S samples
    (E=2, H=16: B1 at 2 x S), B1's launches exactly (1 + SWEEP_REPS) chains x
    4 rollouts x 17 control steps per size, one launch at the largest batch
    held to the plain step, then its weak-scaling row at world size 1
    (WEAK_PER samples, the same count of launches).  Returns (the sweep's
    launches at the largest batch, its launches at the others and the
    row's, the max difference)."""
    import torch

    from extended_legged_gym_tpu_torch.parallel.distributed import shutdown
    from extended_legged_gym_tpu_torch.scripts import weak_scaling as ws
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing

    t0 = time.perf_counter()
    per_size = (1 + SWEEP_REPS) * ws.CHAIN * 17
    want = {k: (per_size if k == "B1" else 0) for k in launch_counts()}
    for S in SWEEP_S:
        torch.cuda.synchronize()
        zero_launch_counts()
        r = ws.measure_strong_singlechip(sizes=(S,), device=dev, reps=SWEEP_REPS)[0]
        torch.cuda.synchronize()
        counts = launch_counts()
        log(f"sweep: {r['rollouts']} rollouts (B1 at {r['rollouts']}): {r['t_rollout_s'] * 1e3:.3f}"
            f" ms per rollout_batch, {r['rollouts_per_s']:.1f} rollouts/s; launches {counts}")
        if counts != want:
            fail(f"the sweep at S={S} launched {counts}, not {want}")
    B = 2 * max(SWEEP_S)
    step = ws.rollout_env(2, max(SWEEP_S), 16, dev).decimated_step
    err = compare_one_step("B1 sweep", step, B, near_standing(step.model, B, 8, dev), stats)
    zero_launch_counts()
    row = ws.measure(WEAK_PER, mesh=mesh, device=dev, reps=SWEEP_REPS)
    torch.cuda.synchronize()
    weak = launch_counts()["B1"]
    shutdown()
    log(f"weak-scaling row at world size 1: {row}; B1 launches {weak}")
    if weak != per_size or row["devices"] != 1 or not row["t_rollout_s"] > 0:
        fail(f"the weak-scaling row launched {weak}, not {per_size}, or is malformed: {row}")
    phase_done("weak scaling", t0)
    return per_size, per_size * (len(SWEEP_S) - 1) + weak, err


def commands_path(dev, policy):
    """Phase 38: anymal_c_flat with commands.heading_command and
    commands.curriculum on at CMD_ENVS envs, stepped CMD_STEPS control steps
    by ``policy`` (play's, the committed flat checkpoint's): B1 exactly CMD_STEPS launches; column 2 of
    the commands the P law of column 3 and the base heading (zero for envs
    that reset in the last step); every command, observation and reward
    finite.  Returns the launches."""
    import torch

    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
    from extended_legged_gym_tpu_torch.utils.math import quat_rotate, wrap_to_pi

    t0 = time.perf_counter()
    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = CMD_ENVS
    cfg.commands.heading_command = cfg.commands.curriculum = True
    env = LeggedRobot(cfg, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    with torch.no_grad():
        state = env.reset_all(seed=0)
        torch.cuda.synchronize()
        zero_launch_counts()
        for _ in range(CMD_STEPS):
            state = env.step(state, policy(state.obs))
            finite &= (torch.isfinite(state.obs).all() & torch.isfinite(state.rew).all()
                       & torch.isfinite(state.commands).all())
        torch.cuda.synchronize()
    counts = launch_counts()
    fwd = quat_rotate(state.phys.base_quat,
                      torch.tensor([1.0, 0.0, 0.0], device=dev).expand(CMD_ENVS, 3))
    law = torch.clamp(0.5 * wrap_to_pi(state.commands[:, 3] - torch.atan2(fwd[:, 1], fwd[:, 0])),
                      -1.0, 1.0)
    reset = state.reset_buf
    law_err = (state.commands[~reset, 2] - law[~reset]).abs().max().item()
    reset_col2 = state.commands[reset, 2].abs().max().item() if bool(reset.any()) else 0.0
    want = {k: (CMD_STEPS if k == "B1" else 0) for k in counts}
    log(f"command options: {CMD_STEPS} control steps at {CMD_ENVS} envs: launches {counts}; "
        f"column 2 - P law max {law_err:.3g} over {int((~reset).sum())} envs, column 2 of the "
        f"{int(reset.sum())} just reset {reset_col2:g}; heading range "
        f"[{state.commands[:, 3].min().item():.3f}, {state.commands[:, 3].max().item():.3f}]; "
        f"lin-vel-x range {state.command_lin_vel_x_range.tolist()}; finite {bool(finite)}")
    if counts != want:
        fail(f"the command options' env launched {counts}, not {want}")
    if not (law_err <= 1e-5 and reset_col2 == 0.0 and bool(finite)):
        fail("the heading command's column 2 is not its P law, or values are non-finite")
    phase_done("command options", t0)
    return counts["B1"]


def sim_options_path(dev, stats):
    """Phase 39: ``sim.enforce_dof_vel_limits``, ``asset.armature`` and
    ``sim.solver`` on the card (see the module docstring).  Records B1's
    times at OPT_ENVS in ``stats``; returns (B1 launches, largest difference
    from the plain step)."""
    import numpy as np
    import torch

    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.physics import EngineEnvStep
    from extended_legged_gym_tpu_torch.robots.anymal_c import anymal_c_flat_cfg
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing

    t0 = time.perf_counter()
    cfg = anymal_c_flat_cfg()
    cfg.env.num_envs = OPT_ENVS
    cfg.asset.armature, cfg.sim.enforce_dof_vel_limits = OPT_ARMATURE, False
    env = LeggedRobot(cfg, device=dev)
    step, nj = env.decimated_step, env.model.nj
    vlim = step.tf_host[pk.TF_VLIM:pk.TF_VLIM + nj]
    arm = step.tf_host[pk.TF_ARM:pk.TF_ARM + nj]
    log(f"sim options: {OPT_ENVS} envs, armature {OPT_ARMATURE}, velocity limits off: the "
        f"kernel's velocity-limit rows {sorted(set(vlim.tolist()))}, armature rows "
        f"{sorted(set(arm.tolist()))} (the model's limits {sorted(set(env.model.dof_vel_limits.tolist()))})")
    if step.rough or not (vlim == 500.0).all() or not (arm == np.float32(OPT_ARMATURE)).all():
        fail("the sim options did not reach B1's tables")
    st, ep, act = near_standing(env.model, OPT_ENVS, 21, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    sign = torch.randint(0, 2, st.joint_vel.shape, device=dev, generator=gen) * 2.0 - 1.0
    st = st.replace(joint_vel=OPT_FAST * sign)
    err = compare_one_step("B1 sim options", step, OPT_ENVS, (st, ep, act), stats)
    fast = step.launch(st, act, ep)[0].joint_vel.abs().max().item()
    log(f"B1 sim options: |joint_vel| max {fast:.3g} rad/s after one control step from "
        f"{OPT_FAST:g} (the model's limit {float(env.model.dof_vel_limits.max()):g})")
    if not fast > float(env.model.dof_vel_limits.max()):
        fail("B1 clamped the joint velocities with the velocity limits off")
    with torch.no_grad():
        state = env.reset_all(seed=0)
        torch.cuda.synchronize()
        zero_launch_counts()
        finite = torch.ones((), dtype=torch.bool, device=dev)
        for _ in range(OPT_STEPS):
            state = env.step(state, torch.randn(OPT_ENVS, nj, device=dev, generator=gen))
            finite &= torch.isfinite(state.obs).all() & torch.isfinite(state.rew).all()
        torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: (OPT_STEPS if k == "B1" else 0) for k in counts}
    log(f"sim options env: {OPT_STEPS} control steps: launches {counts}; finite {bool(finite)}")
    if counts != want or not bool(finite):
        fail(f"the sim options' env launched {counts} (want {want}) or went non-finite")
    launches = counts["B1"]
    for solver in ("crba", "aba"):
        cfg = anymal_c_flat_cfg()
        cfg.env.num_envs, cfg.sim.solver = OPT_ENGINE_ENVS, solver
        env = LeggedRobot(cfg, device=dev)
        with torch.no_grad():
            state = env.reset_all(seed=0)
            torch.cuda.synchronize()
            zero_launch_counts()
            n0 = EngineEnvStep.engine_substeps
            t1 = time.perf_counter()
            for _ in range(OPT_STEPS):
                state = env.step(state, torch.randn(OPT_ENGINE_ENVS, nj, device=dev,
                                                    generator=gen))
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / OPT_STEPS * 1e3
        counts, substeps = launch_counts(), EngineEnvStep.engine_substeps - n0
        finite = all(bool(torch.isfinite(getattr(state.phys, k)).all())
                     for k in ("base_pos", "base_quat", "joint_pos", "joint_vel"))
        log(f"sim.solver {solver!r} at {OPT_ENGINE_ENVS} envs: {OPT_STEPS} control steps, "
            f"kernel launches {counts}, engine substeps {substeps} (want "
            f"{OPT_STEPS * cfg.control.decimation}), {ms:.1f} ms per control step, state "
            f"finite {finite}")
        if (any(counts.values()) or substeps != OPT_STEPS * cfg.control.decimation
                or env.engine_step.sp.solver != solver or not finite):
            fail(f"sim.solver {solver!r} did not run the plain engine alone, or went non-finite")
    log("metrics sinks the training paths' MetricsWriter wrote: "
        + "; ".join(" + ".join(s) for s in sorted(SINKS_SEEN)))
    phase_done("sim options", t0)
    return launches, err


def main():
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    from extended_legged_gym_tpu_torch.ops import physics_kernel as pk
    from extended_legged_gym_tpu_torch.physics import load_model
    from extended_legged_gym_tpu_torch.robots.anymal_c_traj import (
        AnymalCTrajGradSampling, anymal_c_traj_sampling_cfg)
    from extended_legged_gym_tpu_torch.scripts import bench_mpc
    from extended_legged_gym_tpu_torch.scripts.bench_kernel import near_standing, rough_env
    from extended_legged_gym_tpu_torch.envs.legged_robot import LeggedRobot
    from extended_legged_gym_tpu_torch.scripts.eval_policy import evaluate
    from extended_legged_gym_tpu_torch.scripts.eval_rough import eval_cfg, load_policy, run_eval
    from extended_legged_gym_tpu_torch.utils.device import resolve_device

    # ---------------- 1. device ----------------
    dev = resolve_device("cuda")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind} x{count}")
    log(smi)
    phase_done("device", t0)

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    pk.load_library()
    for line in pk.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "stack frame")):
            log(f"ptxas: {line.strip()}")
    phase_done("build", t0)

    # ---------------- 3. B1 against plain ----------------
    t0 = time.perf_counter()
    cfg = anymal_c_traj_sampling_cfg(1)
    model = load_model(cfg.asset.file)
    step = AnymalCTrajGradSampling(cfg, device=dev).decimated_step
    log(f"B1 block of {pk.ENVS_PER_BLOCK} envs: "
        f"{pk.block_shared_bytes(model.nb, model.nj, model.ng, step.nf)} bytes of shared memory")
    flat_stats, flat_err = {}, 0.0
    for B in CHECK_B:
        flat_err = max(flat_err, compare_one_step("B1", step, B, near_standing(model, B, B, dev),
                                                  flat_stats))
    drift_check("B1", step, 776, near_standing(model, 776, 7, dev))
    bit_identical("B1", step, 1024, near_standing(model, 1024, 1, dev))
    bit_identical("B1", step, 4096, near_standing(model, 4096, 3, dev))
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("B1 vs plain", t0)

    # ---------------- 4. B2 against plain ----------------
    t0 = time.perf_counter()
    renv = rough_env(max(ROUGH_B), dev)
    rstep = renv.decimated_step
    if not rstep.rough:
        fail("the rough env's physics step is not B2")
    log(f"B2 block of {pk.ENVS_PER_BLOCK} envs: "
        f"{pk.block_shared_bytes(model.nb, model.nj, model.ng, rstep.nf, True)} bytes of shared memory")
    origins = renv.reset_all(seed=0).env_origins
    log(f"rough terrain {renv.terrain.shape[0]} x {renv.terrain.shape[1]} at "
        f"{renv.terrain.hscale:.3g} m; spawn levels 0..{int(renv.init_terrain_levels.max())}")
    rough_stats, rough_err = {}, 0.0
    for B in ROUGH_B:
        rough_err = max(rough_err, compare_one_step(
            "B2", rstep, B, near_standing(model, B, B, dev, origins), rough_stats))
    drift_check("B2", rstep, 32, near_standing(model, 32, 11, dev, origins))
    bit_identical("B2", rstep, 4096, near_standing(model, 4096, 2, dev, origins))
    log("no single PyTorch call computes this step; library_ms is null")
    phase_done("B2 vs plain", t0)

    # ---------------- 5. MPC path ----------------
    t0 = time.perf_counter()
    E, n_warm, n_cycles = 8, 6, 14
    cfg = anymal_c_traj_sampling_cfg(E)
    cfg.rl_warmstart.policy_checkpoint = CKPT
    cfg.commands.resampling_time = 1e9
    cfg.commands.ranges.lin_vel_x = [CMD, CMD]
    cfg.commands.ranges.lin_vel_y = [0.0, 0.0]
    cfg.commands.ranges.ang_vel_yaw = [0.0, 0.0]
    env = AnymalCTrajGradSampling(cfg, device=dev)
    env.setup_rl_warmstart()
    pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
    state = env.reset_all(seed=0)
    nodes = env.init_trajectories_from_rl(state)
    vx, up, resets = [], [], 0
    for i in range(n_warm + n_cycles):
        state, nodes, _ = env.mpc_step(state, nodes, n_diffuse=6 if i < n_warm else None)
        if i >= n_warm:
            vx.append(state.base_lin_vel[:, 0])
            up.append(state.projected_gravity[:, 2])
            resets += int(state.reset_buf.sum())
    torch.cuda.synchronize()
    flat_launches = pk.DecimatedEnvStep.launches
    vx, up = torch.stack(vx), torch.stack(up)
    half = n_cycles // 2
    ratio = vx[half:].mean().item() / CMD
    upright = up[half:].mean().item()
    log(f"MPC path: {n_warm}+{n_cycles} mpc_step cycles, E={E}: achieved/command={ratio:.4f} "
        f"upright_mean={upright:.4f} resets={resets} B1 launches={flat_launches} "
        f"B2 launches={pk.DecimatedEnvStep.rough_launches}")
    if flat_launches <= 0:
        fail("the MPC path launched B1 no time")
    if not (torch.isfinite(vx).all() and torch.isfinite(up).all() and torch.isfinite(nodes).all()):
        fail("non-finite values on the MPC path")
    if not upright < -0.9:
        fail(f"robots did not stay upright (upright_mean {upright:.3f})")
    phase_done("MPC path", t0)

    # ---------------- 6. rough path ----------------
    t0 = time.perf_counter()
    policy = load_policy(ROUGH_CKPT, renv.num_obs, renv.num_actions, dev)
    cmd = torch.zeros(renv.num_envs, 4, device=dev)
    cmd[:, 0] = CMD
    with torch.no_grad():
        state = renv.reset_all(seed=0).replace(commands=cmd)
        pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
        up, finite = [], True
        for _ in range(ROUGH_STEPS):
            state = renv.step(state, policy(state.obs)).replace(commands=cmd)
            up.append(state.projected_gravity[:, 2])
            finite = finite and bool(torch.isfinite(state.obs).all())
        torch.cuda.synchronize()
        rough_launches = pk.DecimatedEnvStep.rough_launches
        upright = torch.stack(up).mean().item()
        log(f"rough path: {ROUGH_STEPS} control steps, {renv.num_envs} envs, obs "
            f"{tuple(state.obs.shape)}: B2 launches={rough_launches} B1 launches="
            f"{pk.DecimatedEnvStep.launches} upright_mean={upright:.4f} obs finite={finite} "
            f"falls={int((state.reset_buf & ~state.time_out_buf).sum())} (last step)")
        if rough_launches != ROUGH_STEPS:
            fail(f"the rough path launched B2 {rough_launches} times, not {ROUGH_STEPS}")
        if not finite:
            fail("non-finite observations on the rough path")
        if not upright < -0.9:
            fail(f"rough-path robots did not stay upright (upright_mean {upright:.3f})")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(ROUGH_STEPS):
            state = renv.step(state, policy(state.obs)).replace(commands=cmd)
        torch.cuda.synchronize()
        sps = ROUGH_STEPS / (time.perf_counter() - t1)
    log(f"rough env at {renv.num_envs} envs, policy included: {sps:.2f} control steps/s "
        f"({sps * renv.num_envs:.0f} env-steps/s)")
    res = run_eval(ROUGH_CKPT, 32, 100, 50, CMD, max_init_level=2, seed=0, device=dev)
    log(f"short rough eval (32 envs, 50+100 steps, levels <= 2): achieved/command="
        f"{res['achieved_over_command']} upright_mean={res['upright_mean']} "
        f"falls={res['falls']} by type {res['falls_by_terrain_type']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean")):
        fail("non-finite values in the short rough eval")
    phase_done("rough path", t0)

    # ---------------- 7. V-control routes ----------------
    t0 = time.perf_counter()
    venvs = (("flat_v", AnymalCTrajGradSampling(v_control(anymal_c_traj_sampling_cfg(V_FLAT_B)),
                                                device=dev), V_FLAT_B, None),
             ("rough_v", LeggedRobot(v_control(eval_cfg(V_ROUGH_B)), device=dev), V_ROUGH_B,
              origins))
    v_stats, v_err, v_launches = {}, {}, {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, venv, B, org in venvs:
        vstep = venv.substep
        if venv.decimated_step is not None or vstep.rough != (org is not None):
            fail(f"{name}: the V-control env does not run the per-substep route")
        st, ep, act = near_standing(model, B, 5, dev, org)
        v_stats[name] = {}
        v_err[name] = compare_one_step(name, vstep, B, (st, ep, 20.0 * act), v_stats[name])
        with torch.no_grad():
            state = venv.reset_all(seed=0)
            pk.EnvStep.launches = pk.EnvStep.rough_launches = 0
            pk.DecimatedEnvStep.launches = pk.DecimatedEnvStep.rough_launches = 0
            finite = True
            for _ in range(V_STEPS):
                a = torch.randn(B, venv.num_actions, device=dev, generator=gen)
                state = venv.step(state, a)
                finite = finite and bool(torch.isfinite(state.obs).all())
            torch.cuda.synchronize()
        v_launches[name] = pk.EnvStep.rough_launches if vstep.rough else pk.EnvStep.launches
        want = V_STEPS * venv.cfg.control.decimation
        log(f"{name} env: {V_STEPS} control steps, {B} envs: route launches={v_launches[name]} "
            f"(want {want}), fused launches B1={pk.DecimatedEnvStep.launches} "
            f"B2={pk.DecimatedEnvStep.rough_launches}, torques |max|="
            f"{state.torques.abs().max().item():.3g}, obs finite={finite}")
        if v_launches[name] != want:
            fail(f"{name}: the V route launched {v_launches[name]} times, not {want}")
        if pk.DecimatedEnvStep.launches or pk.DecimatedEnvStep.rough_launches:
            fail(f"{name}: the V-control env launched the fused control step")
        if not finite:
            fail(f"{name}: non-finite observations under V control")
    phase_done("V routes", t0)

    # ---------------- 8. training path ----------------
    t0 = time.perf_counter()
    train_launches = training_path(dev, "anymal_c_flat", 2, TRAIN_ITERS)
    phase_done("training path", t0)

    # ---------------- 9. rough training path ----------------
    t0 = time.perf_counter()
    rough_train_launches = training_path(dev, "anymal_c_rough", 1, ROUGH_TRAIN_ITERS)
    phase_done("rough training path", t0)

    # ---------------- 10-11. ray path and depth camera ----------------
    ray_launches = ray_path(dev)

    # ---------------- 12. estimator path ----------------
    est_launches = estimator_path(dev)

    # ---------------- 13. distillation path ----------------
    distill_launches = distill_path(dev)

    # ---------------- 14-16. ElSpider, SEA, RL extensions ----------------
    elspider_stats, sea_stats = {}, {}
    elspider_err, elspider_launches = elspider_path(dev, elspider_stats)
    sea_err, sea_launches = sea_path(dev, sea_stats)
    ext_launches = extensions_path(dev)

    # ---------------- 17-18. the fixed-base regime: Franka ----------------
    franka_stats = {}
    franka_err, franka_launches = franka_path(dev, franka_stats)

    # ---------------- 19. CyberDog2 on B1 ----------------
    cyber_stats = {}
    cyber_err, cyber_launches = cyberdog2_path(dev, cyber_stats)

    # ---------------- 20-22. the LeggedRobot family ----------------
    family_stats, family_launches = {}, {}
    family_err = family_kernels(dev, family_stats)
    family_training(dev, family_launches)
    family_stepping(dev, family_launches)

    # ---------------- 23-28. confined perception, the engine route, the new MPC, planning
    # and training paths ----------------
    perception_path(dev)
    engine_vs_cpu(dev)
    mpc_cycle(dev, "elair_timberpile_nav", "engine", n_diffuse=ENGINE_DIFFUSE)
    percept_launches, _ = mpc_cycle(dev, "anymal_c_percept", "B1")
    barrier_launches, _ = mpc_cycle(dev, "anymal_c_nav_barrier", "B2")
    mpc_cycle(dev, "anymal_c_plan_grad_sampling", "none")
    new_stats = {}
    new_err = new_kernels(dev, new_stats)
    new_launches = {}
    new_training(dev, new_launches)
    flat_err = max(flat_err, new_err[("B1", "anymal_c", NAV_B)])
    elspider_err = max(elspider_err, new_err[("B1", "elspider_air", NAV_B)])
    rough_err = max(rough_err, new_err[("B2", "anymal_c", NAV_B)])
    family_launches[("B2", "elspider_air")] += new_launches[("B2", "elspider_air")]

    # ---------------- 29-32. the polish modes, gradients on the card, the last slice's
    # tasks and kernel pairs ----------------
    polish_launches = polish_modes(dev)
    gradients_on_card(dev)
    new14_launches = {}
    new_tasks_14(dev, new14_launches)
    for key, n in new14_launches.items():
        family_launches[key] = family_launches.get(key, 0) + n
    pairs_stats = {}
    pairs_err = new_pairs_14(dev, pairs_stats)
    flat_err = max(flat_err, pairs_err[("B1", "anymal_c", 1)])
    family_err[("B2", "elspider_air")] = max(family_err[("B2", "elspider_air")],
                                             pairs_err[("B2", "elspider_air", 512)])

    # ---------------- 33-38. play, export, nccl, data-parallel PPO, the saturation sweep, the
    # command options
    play_stats, sweep_stats = {}, {}
    play_launches, play_err, played = play_path(dev, play_stats)
    export_path(dev, played)
    mesh = nccl_path(dev)
    dp_launches = dp_path(dev, mesh)
    sweep_launches, other_sweep_launches, sweep_err = sweep_path(dev, mesh, sweep_stats)
    cmd_launches = commands_path(dev, played["runner"].get_inference_policy())

    # ---------------- 39. sim options ----------------
    opt_stats = {}
    opt_launches, opt_err = sim_options_path(dev, opt_stats)
    flat_err = max(flat_err, opt_err)

    # ---------------- 40. flat evaluation ----------------
    t0 = time.perf_counter()
    res = evaluate("anymal_c_flat", FLAT_CKPT, CMD, envs=16, steps=100, warmup=50, device=dev)
    log(f"flat evaluation of the committed JAX checkpoint (16 envs, 50+100 steps): "
        f"achieved/command={res['achieved_over_command']} upright_mean={res['upright_mean']} "
        f"base_height_mean={res['base_height_mean']} falls={res['falls']}")
    if not all(math.isfinite(res[k]) for k in ("achieved_over_command", "upright_mean",
                                                "base_height_mean", "falls")):
        fail("non-finite values in the flat evaluation")
    if not res["upright_mean"] < -0.9:
        fail(f"flat evaluation: robots did not stay upright (upright_mean {res['upright_mean']})")
    phase_done("flat evaluation", t0)

    # ---------------- 41. timing ----------------
    t0 = time.perf_counter()
    solves, _ = bench_mpc.solve_latency(dev, n_solves=TIMING_SOLVES)
    log(f"solve at E=1 (Nsample=127 Hsample=16 Hnode=4 Ndiffuse=2 polish=fd x2): "
        f"p50 {bench_mpc.percentile(solves, 50):.2f} ms, p90 {bench_mpc.percentile(solves, 90):.2f} ms "
        f"over {len(solves)} solves")
    rb_ms, rps = bench_mpc.rollout_throughput(dev, E=16, S=128, H=64)
    log(f"rollout_batch E=16 S=128 H=64: {rb_ms:.1f} ms, {rps:.1f} rollouts/s")
    phase_done("timing", t0)

    # ---------------- 42. result ----------------
    src = "extended_legged_gym_tpu_torch/csrc/physics_step.cu"
    kernels = []
    replaces = "extended_legged_gym_tpu/ops/physics_kernel.py:447"
    fam = lambda route, robot: family_launches.get((route, robot), 0)
    family_entries = tuple(
        (f"{'flat' if route == 'B1' else 'rough'}_decimated_physics_step_{robot}",
         fam(route, robot), family_err[(route, robot)], family_stats[(route, robot)][FLEET])
        for route, robot in family_err if route != "fixed")
    for name, launches, err, ks in (
            ("flat_decimated_physics_step",
             flat_launches + train_launches + distill_launches + ext_launches
             + fam("B1", "anymal_c") + percept_launches + new_launches[("B1", "anymal_c")]
             + polish_launches + dp_launches + other_sweep_launches + cmd_launches
             + opt_launches, flat_err,
             flat_stats[4096]),
            ("flat_decimated_physics_step_play_b50", play_launches, play_err,
             play_stats[PLAY_B]),
            ("flat_decimated_physics_step_sweep_b8192", sweep_launches, sweep_err,
             sweep_stats[2 * max(SWEEP_S)]),
            ("flat_decimated_physics_step_cassie", fam("B1", "cassie"),
             pairs_err[("B1", "cassie", 128)], pairs_stats[("B1", "cassie", 128)][128]),
            ("flat_decimated_physics_step_elspider_air",
             elspider_launches + fam("B1", "elspider_air"), elspider_err, elspider_stats[4096]),
            ("flat_physics_substep_sea_route", sea_launches, sea_err, sea_stats[FLEET]),
            ("fixed_base_decimated_physics_step_franka", franka_launches, franka_err,
             franka_stats[FRANKA_FLEET]),
            ("flat_decimated_physics_step_cyberdog2", cyber_launches, cyber_err,
             cyber_stats[CYBER_B]),
            ("fixed_base_decimated_physics_step_elspider_air", fam("fixed", "elspider_air"),
             family_err[("fixed", "elspider_air")], family_stats[("fixed", "elspider_air")][FLEET]),
            ("rough_decimated_physics_step",
             rough_launches + ray_launches + rough_train_launches + est_launches
             + fam("B2", "anymal_c") + barrier_launches, rough_err, rough_stats[4096]),
            ("flat_physics_substep_v_route", v_launches["flat_v"], v_err["flat_v"],
             v_stats["flat_v"][V_FLAT_B]),
            ("rough_physics_substep_v_route", v_launches["rough_v"], v_err["rough_v"],
             v_stats["rough_v"][V_ROUGH_B])) + family_entries:
        if launches <= 0:
            fail(f"{name} was launched no time on its paths")
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches, "max_abs_err": err, "ms": ks["ms"],
                        "plain_ms": ks["plain_ms"], "bound_ms": ks["bound_ms"],
                        "bound_by": ks["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
