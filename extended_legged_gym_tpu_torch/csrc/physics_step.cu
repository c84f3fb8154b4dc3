// Fused, decimated physics step for NVIDIA Hopper (sm_90a), flat and rough.
//
// Replaces the TPU kernels of extended_legged_gym_tpu/ops/physics_kernel.py,
// build_physics_kernel (:50, kernel body :136-419, pallas_call :447):
//   B1, rough=False, as driven by make_decimated_env_step (:626-735) and
//       make_env_step (:517) on flat ground: entry physics_decimated_step;
//   B2, rough=True, as driven by make_env_step_rough (:565) and
//       make_decimated_env_step (:626) on a heightfield: entry
//       physics_decimated_step_rough.
// One launch advances B environments by one CONTROL step: for each of
// `decimation` substeps it computes the PD (or direct) torques and runs one
// semi-implicit-Euler ABA step: forward kinematics and velocities,
// sphere-vs-terrain penalty contacts (depth clamp, no-adhesion kd cap,
// tangential damping, anchor stiction), implicit contact damper dt*Ds added to
// the articulated inertias, backward sweep, 6x6 Cholesky base solve, forward
// sweep, clamped integration with an exp-map quaternion.  The last substep also
// reports the contact force on every geom (implicit-consistent, post-step
// point velocities) and foot kinematics.  Its plain version is physics/aba.py
// (aba_physics_step), run once per substep; the wrapper is
// ops/physics_kernel.py.  The V-control routes launch it with decimation 1,
// direct torques and action scale 1.
//
// B1 contacts a plane at a constant height (n = z).  B2 reads, for every geom
// in every substep, the four bilinear corners of the heightfield cell under the
// geom from a corner-packed texture [H*W] of float4 (one 16-byte read; the
// 900 x 900 grid of the rough task is 13 MB and stays in the 50 MB L2), and
// takes the height and the normalised analytic gradient normal of the bilinear
// patch, as terrain/heightfield.py:sample_height_and_normal does; the gap is
// vertical, the anchor displacement is projected on the tangent plane and the
// damper D = kt I + (kd_g - kt) n n^T enters the articulated inertias with that
// n.  Unlike the Pallas B2, which samples one tangent plane per geom per
// control step at the previous control step's geom positions and extrapolates
// inside the kernel, this kernel samples the grid at the current geom position
// in every substep, as the ABA engine does: no geom-position carry, no stale
// plane.
//
// What bounds it on an H100: for ANYmal-C one env's control step needs
// ~8.9e4 float operations in B1 and ~1.0e5 in B2 (counted blockwise in
// ops/physics_kernel.py:control_step_flops) and moves ~1.5 KB of state and
// outputs (B2: plus 16 bytes per geom per substep of corner reads, ~3.8 KB),
// so at B = 3..4096 envs a launch is at most ~4e8 operations and ~16 MB: the
// card's rate bounds (67 TFLOP/s float32, 3.35 TB/s) put it at a few
// microseconds.  What bounds it in practice is latency: a control step is a
// chain of dependent phases (kinematics down the tree, contacts, a sweep up, a
// 6x6 solve, a sweep down) that one env cannot skip, and a warp that runs it
// alone issues few independent instructions.  The first design ran the chain
// on one thread per env with a 16 KB local-memory stack, one warp per SM.
//
// Design: one WARP per environment (GROUP = 32 lanes), ENVS_PER_BLOCK warps per
// block, so B = 1024 launches 256 blocks over all 132 SMs; a block takes
// ~54-56 KB of shared memory for ANYmal-C, and BLOCKS_PER_SM of them fit an
// SM at once (B2: 4, at 128 registers a thread; B1: 3, as it spills at 128),
// so B = 4096 runs in two waves of B2.  Each env's
// working set (frames, velocities, articulated inertias, U / D^-1 / u, geom
// terms, the state row, outputs) lives in dynamic shared memory, laid out by
// ws_layout() from the robot's real nb, nj, ng, nf (not the compile-time
// maxima): about 11 KB for ANYmal-C; the block also copies the model tables
// and the tree schedule there once, so no phase waits on a global load.  The
// wrapper computes the same size, and physics_set_workspace_bytes() raises
// the kernels' dynamic shared-memory limit when a block needs more than
// 48 KB.  The schedule (each body's depth, the bodies by depth, each geom's
// slot body by body, each body's children) is built by the wrapper from
// `parent` and `geom_body` and rides after TI_SIZE in the int table.  The step
// is a sequence of phases separated by __syncwarp(); inside a phase each lane
// owns disjoint tasks and reads nothing another lane writes in that phase:
//   * kinematics: each body (one per lane) walks its path from the base in
//     registers (joint rotations, frames, positions, velocities), the same
//     operations its ancestors' lanes run, so the same bits: one phase
//     instead of one per tree level; likewise the forward sweep;
//   * contacts run one geom per lane (ANYmal-C: 36 geoms in two passes), so
//     B2's 32 heightfield reads of a pass are in flight at once; each geom
//     leaves its damper and wrench terms in a slot ordered body by body;
//   * each body (one lane) then sums its own geoms' terms into its
//     articulated inertia and bias force;
//   * the backward sweep runs by depth level, deepest first: each body of the
//     level (one lane) adds its children's terms, then computes in registers
//     U, D, u, Ia, pa and the blockwise congruence X^T Ia X it hands its
//     parent; the base's lane adds its children's and solves the 6x6 system
//     by Cholesky.  Every sum has a fixed order (geoms and children in index
//     order), so two launches on the same inputs give the same bits: no
//     atomics.  Spreading the 6x6 entries over the lanes, one entry per
//     task, was measured slower: each pass of such a phase is a chain of
//     dependent shared-memory round trips (PERF.md, Findings);
//   * integration, the report and the torques run one DOF, geom or foot per
//     lane.
// Division uses the card's approximate instruction (see FDIV below).  The block stages its SoA [rows, B] loads and stores through
// shared memory with the env index fastest, so the global accesses stay
// coalesced.  The model comes in as two small device tables, one of floats
// and one of ints, laid out by the offsets below (mirrored in
// ops/physics_kernel.py); one build serves every robot under the maxima.
//
// The same source compiles with a host C++ compiler (tests/
// test_torch_kernel_host.py): there FOR_LANES runs the lanes of a phase one
// after another (in either order, a check that no lane reads what another
// writes in the same phase), SYNC() is empty and a host array stands for the
// shared memory, so the test runs this cooperative body itself.

// Division on the card is the hardware's approximate one (__fdividef, 2 ulp;
// the divisors here are bounded), which shortens the dependent chains; the
// host build divides exactly.  Sine and cosine stay precise: the approximate
// ones have an absolute error bound, a large relative error for the small
// angles of the exp-map half-angle and of 1 - cos, and they moved the card's
// last-substep torques past tests/test_torch_kernel_cuda.py's tolerance.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PHYS_HD __host__ __device__ __forceinline__
#define PHYS_DEV __device__ __forceinline__
#define LDG(p) __ldg(p)
#define FDIV(a, b) __fdividef((a), (b))
#else
#define PHYS_HD inline
#define PHYS_DEV inline
#define LDG(p) (*(p))
#define FDIV(a, b) ((a) / (b))
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
#endif
#include <math.h>

#define MAX_NB 32
#define MAX_NJ 31
#define MAX_NG 64
#define MAX_NF 8

// ---- int table (ti) ----
#define TI_NB 0
#define TI_NJ 1
#define TI_NG 2
#define TI_NF 3
#define TI_DECIM 4
#define TI_CTRL 5          // 0: P (PD on position targets), 1: T (direct torque)
#define TI_TH 6            // heightfield rows H (rough)
#define TI_TW 7            // heightfield columns W (rough)
#define TI_PARENT 8
#define TI_GBODY (TI_PARENT + MAX_NB)
#define TI_FGEOM (TI_GBODY + MAX_NG)
#define TI_SIZE (TI_FGEOM + MAX_NF)
// schedule, built by the wrapper from `parent` and `geom_body` (after TI_SIZE,
// so a kernel of the one-thread-per-env design reads the same table)
#define TI_DEPTH TI_SIZE                  // [MAX_NB] depth of each body (base 0)
#define TI_LVL (TI_DEPTH + MAX_NB)        // [MAX_NB] bodies by depth, then index
#define TI_LOFF (TI_LVL + MAX_NB)         // [MAX_NB + 1] first slot of each depth in TI_LVL
#define TI_GOFF (TI_LOFF + MAX_NB + 1)    // [MAX_NB + 1] first geom slot of each body
#define TI_GSLOT (TI_GOFF + MAX_NB + 1)   // [MAX_NG] slot of each geom, body by body
#define TI_COFF (TI_GSLOT + MAX_NG)       // [MAX_NB + 1] first entry of each body's children
#define TI_CLIST (TI_COFF + MAX_NB + 1)   // [MAX_NB] children, by parent, then index
#define TI_MAXD (TI_CLIST + MAX_NB)       // depth of the deepest body
#define TI_FULL (TI_MAXD + 1)

// ---- float table (tf) ----
#define TF_DT 0
#define TF_G 1             // gravity x, y, z
#define TF_KP 4
#define TF_KD 5
#define TF_KT 6
#define TF_MU 7            // contact mu x terrain friction
#define TF_KTS 8
#define TF_JDAMP 9
#define TF_H0 10           // plane height
#define TF_ASCALE 11       // action scale
#define TF_JROT 16                          // [MAX_NB][9] joint origin rotation
#define TF_JPOS (TF_JROT + MAX_NB * 9)      // [MAX_NB][3] joint origin position
#define TF_JAXIS (TF_JPOS + MAX_NB * 3)     // [MAX_NB][3] joint axis (child frame)
#define TF_ISP (TF_JAXIS + MAX_NB * 3)      // [MAX_NB][36] spatial inertia at nominal mass
#define TF_IUNIT0 (TF_ISP + MAX_NB * 36)    // [36] base spatial inertia per kg of added mass
#define TF_MASS (TF_IUNIT0 + 36)            // [MAX_NB]
#define TF_COM (TF_MASS + MAX_NB)           // [MAX_NB][3]
#define TF_ARM (TF_COM + MAX_NB * 3)        // [MAX_NJ] armature
#define TF_TLIM (TF_ARM + MAX_NJ)           // [MAX_NJ] torque limit
#define TF_VLIM (TF_TLIM + MAX_NJ)          // [MAX_NJ] velocity limit (<= 500)
#define TF_PGAIN (TF_VLIM + MAX_NJ)         // [MAX_NJ]
#define TF_DGAIN (TF_PGAIN + MAX_NJ)        // [MAX_NJ]
#define TF_DDP (TF_DGAIN + MAX_NJ)          // [MAX_NJ] default joint position
#define TF_GOFF (TF_DDP + MAX_NJ)           // [MAX_NG][3] geom offset (body frame)
#define TF_GRAD (TF_GOFF + MAX_NG * 3)      // [MAX_NG] geom radius
#define TF_FOFF (TF_GRAD + MAX_NG)          // [MAX_NF][3] foot offset (body frame)
#define TF_HS (TF_FOFF + MAX_NF * 3)        // heightfield spacing (rough)
#define TF_ORG (TF_HS + 1)                  // [2] world xy of grid index (0, 0)
#define TF_GMAX (TF_ORG + 2)                // [2] grid-coordinate clips H - 1.001, W - 1.001
#define TF_SIZE (TF_GMAX + 2)

// ---- cooperative execution ----
#define GROUP 32           // lanes per environment: one warp
#define ENVS_PER_BLOCK 4   // environments (warps) per block
// Blocks an SM holds at once (the register cap that follows): B2 fits 4 (128
// registers a thread) without spilling, B1 spills at 4 and takes 3.
#define BLOCKS_PER_SM(rough) ((rough) ? 4 : 3)
#ifdef __CUDACC__
#define FOR_LANES(l) for (int l = (int)(threadIdx.x % GROUP), l##_run = 1; l##_run; l##_run = 0)
#ifdef PHYS_PROFILE
// phase profile (scripts/profile_phases.py): lane 0 of block 0 stamps the SM
// clock at the kernel's entry, after its staging and at every phase boundary
#define PROF_MAX 512
__device__ long long phys_prof[PROF_MAX];
__device__ int phys_prof_n;
#define PROF_STAMP()                                                              \
  do {                                                                            \
    if (blockIdx.x == 0 && threadIdx.x == 0 && phys_prof_n < PROF_MAX)           \
      phys_prof[phys_prof_n++] = clock64();                                       \
  } while (0)
#define SYNC()                                                                    \
  do {                                                                            \
    __syncwarp();                                                                 \
    PROF_STAMP();                                                                 \
  } while (0)
#else
#define PROF_STAMP()
#define SYNC() __syncwarp()
#endif
#else
static int phys_lanes_reversed = 0;   // host emulation: run a phase's lanes last to first
#define FOR_LANES(l)                                                            \
  for (int l##_k = 0; l##_k < GROUP; ++l##_k)                                   \
    for (int l = phys_lanes_reversed ? GROUP - 1 - l##_k : l##_k, l##_run = 1;  \
         l##_run; l##_run = 0)
#define SYNC()
#endif

// ---- per-env workspace (shared memory), sized from the model ----
// Each body's data sit in one block of BSTR words at the start of the env's
// workspace, so every per-body field is the workspace pointer plus a
// compile-time offset (few registers stay live across the step).  6x6 blocks
// and geom terms are read 16 bytes at a time by one lane per body; the
// strides (92 and 28 words, -4 mod 32) keep the 8 lanes of each quarter-warp
// on distinct banks, and scalar accesses of lanes 8 apart share a bank.
#define BSTR 92            // per body: IA(36) R(9) E(9) P(3) V(6) c(6) a(6) pA(6) U(6) 1/D u, pad
#define BO_IA 0            // articulated inertia, 6x6 (16-byte aligned)
#define BO_R 36            // frame, 3x3
#define BO_E 45            // joint rotation from the parent, 3x3
#define BO_P 54            // position
#define BO_V 57            // spatial velocity
#define BO_CB 63           // bias acceleration v x vj
#define BO_AC 69           // spatial acceleration
#define BO_PA 75           // bias force
#define BO_U 81            // U = IA S
#define BO_DINV 87         // 1 / D
#define BO_UU 88           // u
#define GC_STR 28          // per geom: 21 damper entries (upper triangle), 6 wrench, 1 pad
struct WsLayout {
  int S, ACT, TAU, QDD, FRIC, DELTA, IB0, GC, GST, GF, FP, FV;
  int words;
};
PHYS_HD int gst_stride(bool rough) { return rough ? 13 : 9; }
// Offsets (in 4-byte words) of one env's working set; mirrored by
// ops/physics_kernel.py:workspace_words.
PHYS_HD WsLayout ws_layout(int nb, int nj, int ng, int nf, bool rough) {
  WsLayout L;
  int o = 0;
#define TAKE(f, n) (L.f = o, o += (n))
#define TAKE16(f, n) (o = (o + 3) & ~3, L.f = o, o += (n))   // 16-byte aligned
  o = BSTR * nb;                     // the body blocks
  TAKE(S, 13 + 2 * nj + 2 * ng); TAKE(ACT, nj); TAKE(TAU, nj); TAKE(QDD, nj);
  TAKE(FRIC, 1); TAKE(DELTA, 1);
  TAKE16(IB0, 36);
  TAKE16(GC, GC_STR * (ng > nb ? ng : nb));
  TAKE(GST, gst_stride(rough) * ng);
#undef TAKE
#undef TAKE16
  L.GF = L.GC;
  L.FP = L.GF + 3 * ng;
  L.FV = L.FP + 3 * nf;
  L.words = (o + 3) & ~3;            // the next env's workspace 16-byte aligned too
  return L;
}

// ---------------------------------------------------------------- small math
PHYS_DEV void m3mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
PHYS_DEV void m3vec(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}
PHYS_DEV void m3Tvec(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = A[i] * v[0] + A[3 + i] * v[1] + A[6 + i] * v[2];
}
PHYS_DEV void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}
// motion transform parent -> child with child rotation E^T: [E^T w, E^T (l - r x w)]
PHYS_DEV void xmot_T(const float* E, const float* r, const float* v, float* o) {
  float rw[3], d[3];
  cross3(r, v, rw);
  for (int k = 0; k < 3; ++k) d[k] = v[3 + k] - rw[k];
  m3Tvec(E, v, o);
  m3Tvec(E, d, o + 3);
}
// O = E S E^T for a symmetric 3x3 S (upper triangle computed, then mirrored)
PHYS_DEV void rot_sym(const float* E, const float* S, float* O) {
  float T[9];  // S E^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      T[3 * i + j] = S[3 * i] * E[3 * j] + S[3 * i + 1] * E[3 * j + 1] + S[3 * i + 2] * E[3 * j + 2];
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      O[3 * i + j] = E[3 * i] * T[j] + E[3 * i + 1] * T[3 + j] + E[3 * i + 2] * T[6 + j];
      O[3 * j + i] = O[3 * i + j];
    }
}
// O = E M E^T
PHYS_DEV void rot_gen(const float* E, const float* M, float* O) {
  float T[9];  // M E^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      T[3 * i + j] = M[3 * i] * E[3 * j] + M[3 * i + 1] * E[3 * j + 1] + M[3 * i + 2] * E[3 * j + 2];
  m3mul(E, T, O);
}

// ---------------------------------------------------------------- terrain (B2)
// Height h and unit normal n of the bilinear patch under world point (x, y),
// as terrain/heightfield.py:sample_height_and_normal computes them.  The clip
// keeps the cell inside the grid (fminf/fmaxf also send a NaN to a bound).
// The texture row holds the cell's corners [h(i,j), h(i,j+1), h(i+1,j), h(i+1,j+1)].
PHYS_DEV float terrain_sample(const float* tf, const int* ti, const float4* __restrict__ tex,
                              float x, float y, float* n) {
  const float hs = tf[TF_HS];
  float gx = fminf(fmaxf(FDIV(x - tf[TF_ORG], hs), 0.f), tf[TF_GMAX]);
  float gy = fminf(fmaxf(FDIV(y - tf[TF_ORG + 1], hs), 0.f), tf[TF_GMAX + 1]);
  float x0 = floorf(gx), y0 = floorf(gy);
  float4 c = LDG(tex + ((int)x0 * ti[TI_TW] + (int)y0));
  float fx = gx - x0, fy = gy - y0;
  // c.x = h00, c.y = h01, c.z = h10, c.w = h11
  float h = c.x * (1.f - fx) * (1.f - fy) + c.z * fx * (1.f - fy) + c.y * (1.f - fx) * fy
            + c.w * fx * fy;
  float dhdx = FDIV((c.z - c.x) * (1.f - fy) + (c.w - c.y) * fy, hs);
  float dhdy = FDIV((c.y - c.x) * (1.f - fx) + (c.w - c.z) * fx, hs);
  float nn = sqrtf(dhdx * dhdx + dhdy * dhdy + 1.f);
  n[0] = FDIV(-dhdx, nn); n[1] = FDIV(-dhdy, nn); n[2] = FDIV(1.f, nn);
  return h;
}

// ---------------------------------------------------------------- phases
// Contact of geom g on body b (one lane): penalty force, caps and stiction, the
// anchor update (in the state row `s`), the report stash `st` and the geom's
// terms `gc`: the 21 upper-triangle entries (row-major) of dt * Ds in body
// coordinates, Ds = [[rx D rx^T, rx D], [D rx^T, D]], D = kt I + kdm n n^T, and
// the wrench (r x fb, fb) of the explicit force f_el - D v, to be subtracted
// from pA.
template <bool ROUGH>
PHYS_DEV void contact_geom(const float* tf, const int* ti, const float4* __restrict__ tex, int g,
                           const float* Rb, const float* Pb, const float* Vb, float* anc,
                           float* st, float* gc, float mu) {
  const float dt = tf[TF_DT], kp = tf[TF_KP], kd = tf[TF_KD], ktmax = tf[TF_KT];
  const float kts = tf[TF_KTS];
  const float go[3] = {tf[TF_GOFF + 3 * g], tf[TF_GOFF + 3 * g + 1], tf[TF_GOFF + 3 * g + 2]};
  const float rad = tf[TF_GRAD + g];
  float gp[3], gvb[3], gv[3], tmp[3];
  m3vec(Rb, go, tmp);
  for (int k = 0; k < 3; ++k) gp[k] = Pb[k] + tmp[k];
  cross3(Vb, go, tmp);
  for (int k = 0; k < 3; ++k) gvb[k] = Vb[3 + k] + tmp[k];
  m3vec(Rb, gvb, gv);

  float fw[3], nbv[3], kt_a, kdm;
  if constexpr (ROUGH) {
    float n[3];
    float h = terrain_sample(tf, ti, tex, gp[0], gp[1], n);
    float depth = (h + rad) - gp[2];
    float active = depth > 0.f ? 1.f : 0.f;
    float depth_a = fminf(fmaxf(depth, 0.f), 2.f * rad + 0.05f);
    float vn = gv[0] * n[0] + gv[1] * n[1] + gv[2] * n[2];
    float vt[3] = {gv[0] - vn * n[0], gv[1] - vn * n[1], gv[2] - vn * n[2]};
    float vt_norm = sqrtf(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2]);
    float fn_el = kp * depth_a;
    float kd_g = fminf(kd, FDIV(fn_el, fmaxf(vn, 1e-6f)));
    float fn_est = fmaxf(fn_el - kd_g * vn, 0.f) * active;
    float kt_eff = fminf(ktmax, FDIV(mu * fn_est, fmaxf(vt_norm, 1e-3f)));
    float dx = gp[0] - anc[0], dy = gp[1] - anc[1];
    // anchor displacement (dx, dy, 0) projected on the tangent plane
    float dnn = dx * n[0] + dy * n[1];
    float dt3[3] = {dx - dnn * n[0], dy - dnn * n[1], -dnn * n[2]};
    float dn = sqrtf(dt3[0] * dt3[0] + dt3[1] * dt3[1] + dt3[2] * dt3[2]);
    float budget = fmaxf(mu * fn_est - kt_eff * vt_norm, 0.f);
    float cf = fminf(1.f, FDIV(budget, fmaxf(kts * dn, 1e-9f)));
    kt_a = kt_eff * active;
    kdm = (kd_g - kt_eff) * active;
    float fel[3];
    for (int k = 0; k < 3; ++k) fel[k] = fn_el * n[k] * active - kts * (cf * active) * dt3[k];
    if (active > 0.f) { anc[0] = gp[0] - cf * dx; anc[1] = gp[1] - cf * dy; }
    else { anc[0] = gp[0]; anc[1] = gp[1]; }
    for (int k = 0; k < 3; ++k) { st[k] = gv[k]; st[3 + k] = fel[k]; st[6 + k] = n[k]; }
    st[9] = kt_a; st[10] = kdm; st[11] = active;
    for (int k = 0; k < 3; ++k) fw[k] = fel[k] - kt_a * gv[k] - kdm * vn * n[k];
    m3Tvec(Rb, n, nbv);                      // n in body coordinates
  } else {
    const float h0 = tf[TF_H0];
    float depth = (h0 + rad) - gp[2];
    float active = depth > 0.f ? 1.f : 0.f;
    float depth_a = fminf(fmaxf(depth, 0.f), 2.f * rad + 0.05f);
    float vn = gv[2];
    float vt_norm = sqrtf(gv[0] * gv[0] + gv[1] * gv[1]);
    float fn_el = kp * depth_a;
    float kd_g = fminf(kd, FDIV(fn_el, fmaxf(vn, 1e-6f)));
    float fn_est = fmaxf(fn_el - kd_g * vn, 0.f) * active;
    float kt_eff = fminf(ktmax, FDIV(mu * fn_est, fmaxf(vt_norm, 1e-3f)));
    float dx = gp[0] - anc[0], dy = gp[1] - anc[1];
    float dn = sqrtf(dx * dx + dy * dy);
    float budget = fmaxf(mu * fn_est - kt_eff * vt_norm, 0.f);
    float cf = fminf(1.f, FDIV(budget, fmaxf(kts * dn, 1e-9f)));
    float fsx = -kts * cf * active * dx, fsy = -kts * cf * active * dy;
    kt_a = kt_eff * active;
    kdm = (kd_g - kt_eff) * active;
    float fz_el = fn_el * active;
    if (active > 0.f) { anc[0] = gp[0] - cf * dx; anc[1] = gp[1] - cf * dy; }
    else { anc[0] = gp[0]; anc[1] = gp[1]; }
    st[0] = gv[0]; st[1] = gv[1]; st[2] = gv[2];
    st[3] = fz_el; st[4] = kt_a; st[5] = kdm; st[6] = active; st[7] = fsx; st[8] = fsy;
    fw[0] = fsx - kt_a * gv[0]; fw[1] = fsy - kt_a * gv[1]; fw[2] = fz_el - (kt_a + kdm) * gv[2];
    for (int k = 0; k < 3; ++k) nbv[k] = Rb[6 + k];   // n = z in body coords: R's third row
  }
  // explicit force into body coords at the body origin
  float fb[3], nfb[3];
  m3Tvec(Rb, fw, fb);
  cross3(go, fb, nfb);
  for (int k = 0; k < 3; ++k) { gc[21 + k] = nfb[k]; gc[24 + k] = fb[k]; }
  gc[27] = 0.f;
  // implicit damper dt Ds: rx D rx^T = kt (|r|^2 I - r r^T) + kdm m m^T,
  // rx D = kt rx + kdm m n^T, m = r x n
  float m[3];
  cross3(go, nbv, m);
  const float kt_d = dt * kt_a, kd_d = dt * kdm;
  const float rr = go[0] * go[0] + go[1] * go[1] + go[2] * go[2];
  const float rx[9] = {0.f, -go[2], go[1], go[2], 0.f, -go[0], -go[1], go[0], 0.f};
  int e = 0;
  for (int a = 0; a < 6; ++a)
    for (int c = a; c < 6; ++c, ++e) {
      if (c < 3)
        gc[e] = kt_d * ((a == c ? rr : 0.f) - go[a] * go[c]) + kd_d * m[a] * m[c];
      else if (a < 3)
        gc[e] = kt_d * rx[3 * a + c - 3] + kd_d * m[a] * nbv[c - 3];
      else
        gc[e] = (a == c ? kt_d : 0.f) + kd_d * nbv[a - 3] * nbv[c - 3];
    }
}

// What a child at r from its parent (rotation E) hands the parent: the 21
// upper-triangle entries (row-major) of X^T Ia X and X^T pa.  The congruence
// is blockwise on the symmetric Ia = [[A, B], [B^T, D]], as the TPU kernel's
// xia_T is, so zero blocks and the zeros of rx are never multiplied: rotate
// A' = E A E^T, B' = E B E^T, D' = E D E^T, then shift by r,
//   X^T Ia X = [[A' - W - W^T - rx D' rx, B' + rx D'], [(B' + rx D')^T, D']],  W = B' rx;
// X^T pa = [E n + r x (E fl), E fl].
PHYS_DEV void child_terms(const float* E, const float* r, const float* Ia, const float* pa,
                          float* cx) {
  float A[9], Bm[9], D[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = Ia[6 * i + j];
      Bm[3 * i + j] = Ia[6 * i + 3 + j];
      D[3 * i + j] = Ia[6 * (3 + i) + 3 + j];
    }
  float Ar[9], Br[9], Dr[9];
  rot_sym(E, A, Ar);
  rot_gen(E, Bm, Br);
  rot_sym(E, D, Dr);
  float W[9], rxD[9], col[3];
  for (int i = 0; i < 3; ++i) {
    cross3(Br + 3 * i, r, W + 3 * i);  // row i of B' rx
    cross3(r, Dr + 3 * i, col);        // column i of rx D' (D' symmetric)
    for (int k = 0; k < 3; ++k) rxD[3 * k + i] = col[k];
  }
  int e = 0;
  for (int i = 0; i < 3; ++i) {
    float Y[3];
    cross3(rxD + 3 * i, r, Y);         // row i of rx D' rx
    for (int j = i; j < 3; ++j) cx[e++] = Ar[3 * i + j] - W[3 * i + j] - W[3 * j + i] - Y[j];
    for (int j = 0; j < 3; ++j) cx[e++] = Br[3 * i + j] + rxD[3 * i + j];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) cx[e++] = Dr[3 * i + j];
  float n[3], fl[3], rf[3];
  m3vec(E, pa, n);
  m3vec(E, pa + 3, fl);
  cross3(r, fl, rf);
  for (int k = 0; k < 3; ++k) { cx[21 + k] = n[k] + rf[k]; cx[24 + k] = fl[k]; }
  cx[27] = 0.f;
}

// Load n (a multiple of 4) floats from 16-byte aligned shared memory.
PHYS_DEV void load16(const float* src, float* dst, int n) {
  for (int q = 0; q < n / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    dst[4 * q] = v.x; dst[4 * q + 1] = v.y; dst[4 * q + 2] = v.z; dst[4 * q + 3] = v.w;
  }
}
// Add n (a multiple of 4) floats from 16-byte aligned shared memory to acc.
PHYS_DEV void add16(const float* src, float* acc, int n) {
  for (int q = 0; q < n / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    acc[4 * q] += v.x; acc[4 * q + 1] += v.y; acc[4 * q + 2] += v.z; acc[4 * q + 3] += v.w;
  }
}
// Add a child's terms (child_terms, 16-byte aligned in shared memory, read 16
// bytes at a time) to the symmetric 6x6 block M and the 6-vector p.
PHYS_DEV void add_child(const float* cx, float* M, float* p) {
  int e = 0, a = 0, c = 0;               // entry e of the upper triangle is (a, c)
  for (int q = 0; q < GC_STR / 4; ++q) {
    const float4 v4 = reinterpret_cast<const float4*>(cx)[q];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    for (int t = 0; t < 4; ++t, ++e) {
      if (e < 21) {
        M[6 * a + c] += v[t];
        if (c != a) M[6 * c + a] += v[t];
        if (++c == 6) c = ++a;
      } else if (e < 27) {
        p[e - 21] += v[t];
      }
    }
  }
}
// Store n (a multiple of 4) floats to 16-byte aligned shared memory.
PHYS_DEV void store16(const float* src, float* dst, int n) {
  for (int q = 0; q < n / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] = make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2],
                                                    src[4 * q + 3]);
}


// ---------------------------------------------------------------- per-env step
// One env's control step by the lanes of its group.  `ws` is the env's
// workspace (ws_layout); on entry it holds the state row (S), the scaled
// actions (ACT), FRIC and DELTA; on exit S holds the new state, TAU the last
// substep's torques, GF / FP / FV the report.  State rows: [pos(3), quat(4),
// jpos(nj), lvel(3), avel(3), jvel(nj), anchors(2 ng)].  `tf` and `ti` are the
// model tables (the kernel passes its block's shared-memory copy).  ROUGH
// selects B2: contacts against the heightfield `tex` (B1 contacts the plane at
// tf[TF_H0]).
template <bool ROUGH>
PHYS_DEV void env_control_step(const float* tf, const int* ti, const float4* __restrict__ tex,
                               float* ws) {
  const int nb = ti[TI_NB], nj = ti[TI_NJ], ng = ti[TI_NG], nf = ti[TI_NF];
  const int decim = ti[TI_DECIM], ctrl = ti[TI_CTRL];
  const WsLayout L = ws_layout(nb, nj, ng, nf, ROUGH);
  const int GS = gst_stride(ROUGH);
  float* s = ws + L.S;
  const float* act = ws + L.ACT;
  float *tau = ws + L.TAU, *qdd = ws + L.QDD;
  float *IB0 = ws + L.IB0, *GC = ws + L.GC, *CX = ws + L.GC, *gst = ws + L.GST;
#define BODY(i, f) (ws + BSTR * (i) + BO_##f)   // field f of body i
  float *gf = ws + L.GF, *fpos = ws + L.FP, *fvel = ws + L.FV;
  const int *depth = ti + TI_DEPTH, *lvl = ti + TI_LVL, *loff = ti + TI_LOFF;
  const int *goff = ti + TI_GOFF, *gslot = ti + TI_GSLOT, *coff = ti + TI_COFF;
  const int *clist = ti + TI_CLIST, maxd = ti[TI_MAXD];
  const float dt = tf[TF_DT], jdamp = tf[TF_JDAMP];
  const float mu = tf[TF_MU] * ws[L.FRIC], delta = ws[L.DELTA];
  const int LV = 7 + nj, AV = 10 + nj, JV = 13 + nj, AN = 13 + 2 * nj;

  // ---- the base's inertia at this env's mass (once per launch) ----
  FOR_LANES(l) {
    for (int k = l; k < 36; k += GROUP) IB0[k] = tf[TF_ISP + k] + delta * tf[TF_IUNIT0 + k];
  }
  SYNC();

  for (int sub = 0; sub < decim; ++sub) {
    const bool last = (sub == decim - 1);

    // ---- kinematics: each body (one per lane) walks its path from the base in
    // registers (the same operations as its ancestors' lanes, so the same bits):
    // joint rotations E_j = Jrot_j Rq(q_j), frames, positions, velocities; it
    // keeps its own E, R, P, V and bias velocity c = v x vj, and the torque of
    // its joint ----
    FOR_LANES(l) {
      if (l < nb) {
        const float x = s[3], y = s[4], z = s[5], w = s[6];
        float Rw[9] = {1.f - 2.f * (y * y + z * z), 2.f * (x * y - w * z), 2.f * (x * z + w * y),
                       2.f * (x * y + w * z), 1.f - 2.f * (x * x + z * z), 2.f * (y * z - w * x),
                       2.f * (x * z - w * y), 2.f * (y * z + w * x), 1.f - 2.f * (x * x + y * y)};
        float Pw[3] = {s[0], s[1], s[2]}, Vw[6], Ew[9], vj[3] = {0.f, 0.f, 0.f};
        m3Tvec(Rw, s + AV, Vw);
        m3Tvec(Rw, s + LV, Vw + 3);
        const int dl = depth[l];
        for (int st = 1; st <= dl; ++st) {
          int j = l;                                   // the ancestor of l at depth st
          for (int u = dl; u > st; --u) j = ti[TI_PARENT + j];
          const float* ax = tf + TF_JAXIS + 3 * j;
          const float* r = tf + TF_JPOS + 3 * j;
          const float jq = s[6 + j];
          // Rodrigues: Rq = I + sin K + (1 - cos) K^2, K = [ax]x, K^2 = ax ax^T - |ax|^2 I
          float c = cosf(jq), sn = sinf(jq), oc = 1.f - c;
          float dg = 1.f - oc * (ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]);
          float oxy = oc * ax[0] * ax[1], oxz = oc * ax[0] * ax[2], oyz = oc * ax[1] * ax[2];
          float Rq[9] = {dg + oc * ax[0] * ax[0], oxy - sn * ax[2], oxz + sn * ax[1],
                         oxy + sn * ax[2], dg + oc * ax[1] * ax[1], oyz - sn * ax[0],
                         oxz - sn * ax[1], oyz + sn * ax[0], dg + oc * ax[2] * ax[2]};
          m3mul(tf + TF_JROT + 9 * j, Rq, Ew);
          float Rj[9], pr[3], Vj[6];
          m3mul(Rw, Ew, Rj);
          m3vec(Rw, r, pr);
          for (int k = 0; k < 3; ++k) Pw[k] += pr[k];
          const float thd = s[JV + j - 1];
          for (int k = 0; k < 3; ++k) vj[k] = ax[k] * thd;
          xmot_T(Ew, r, Vw, Vj);
          for (int k = 0; k < 3; ++k) Vj[k] += vj[k];
          for (int k = 0; k < 9; ++k) Rw[k] = Rj[k];
          for (int k = 0; k < 6; ++k) Vw[k] = Vj[k];
        }
        for (int k = 0; k < 9; ++k) BODY(l, R)[k] = Rw[k];
        for (int k = 0; k < 3; ++k) BODY(l, P)[k] = Pw[k];
        for (int k = 0; k < 6; ++k) BODY(l, V)[k] = Vw[k];
        if (l > 0) {
          for (int k = 0; k < 9; ++k) BODY(l, E)[k] = Ew[k];
          cross3(Vw, vj, BODY(l, CB));
          cross3(Vw + 3, vj, BODY(l, CB) + 3);
          const int j = l - 1;
          const float jq = s[7 + j];
          float t = ctrl == 0
              ? tf[TF_PGAIN + j] * (act[j] + tf[TF_DDP + j] - jq) - tf[TF_DGAIN + j] * s[JV + j]
              : act[j];
          const float tl = tf[TF_TLIM + j];
          tau[j] = fminf(fmaxf(t, -tl), tl);
        }
      }
    }
    SYNC();

    // ---- contacts, one geom per lane; terms in the geom's slot ----
    FOR_LANES(l) {
      for (int g = l; g < ng; g += GROUP) {
        const int b = ti[TI_GBODY + g];
        contact_geom<ROUGH>(tf, ti, tex, g, BODY(b, R), BODY(b, P), BODY(b, V), s + AN + 2 * g,
                            gst + GS * g, GC + GC_STR * gslot[g], mu);
      }
    }
    SYNC();

    // ---- each body (one per lane): IA = I + its geoms' dampers, pA = v x* (I v)
    // - gravity wrench - its geoms' wrenches, geoms in index order ----
    FOR_LANES(l) {
      if (l < nb) {
        const int i = l;
        const float* Inom = i == 0 ? IB0 : tf + TF_ISP + 36 * i;
        const float* Vi = BODY(i, V);
        float acc[GC_STR];
        for (int e = 0; e < GC_STR; ++e) acc[e] = 0.f;
        for (int k = goff[i]; k < goff[i + 1]; ++k) add16(GC + GC_STR * k, acc, GC_STR);
        float Iv[6];
        for (int a = 0; a < 6; ++a) {
          float x = 0.f;
          for (int k = 0; k < 6; ++k) x += Inom[6 * a + k] * Vi[k];
          Iv[a] = x;
        }
        int e = 0;
        float Ii[36];
        for (int a = 0; a < 6; ++a)
          for (int c = a; c < 6; ++c, ++e) {
            Ii[6 * a + c] = Inom[6 * a + c] + acc[e];
            Ii[6 * c + a] = Ii[6 * a + c];
          }
        store16(Ii, BODY(i, IA), 36);
        // v x* (I v) = [w x n + l x f, w x f], minus the gravity wrench
        float t1[3], t2[3], t3[3];
        cross3(Vi, Iv, t1);
        cross3(Vi + 3, Iv + 3, t2);
        cross3(Vi, Iv + 3, t3);
        const float m = tf[TF_MASS + i] + (i == 0 ? delta : 0.f);
        float gb[3], fg[3], cf[3];
        m3Tvec(BODY(i, R), tf + TF_G, gb);
        for (int k = 0; k < 3; ++k) fg[k] = m * gb[k];
        cross3(tf + TF_COM + 3 * i, fg, cf);
        for (int k = 0; k < 3; ++k) {
          BODY(i, PA)[k] = ((t1[k] + t2[k]) - cf[k]) - acc[21 + k];
          BODY(i, PA)[3 + k] = (t3[k] - fg[k]) - acc[24 + k];
        }
      }
    }
    SYNC();

    // ---- backward sweep, deepest level first: each body of the level (one
    // per lane) adds its children's terms to its IA and pA (children in index
    // order), then forms U = IA S, D, u, Ia = IA - U U^T / D, pa = pA + Ia c +
    // U u / D and its own terms for its parent ----
    for (int d = maxd; d >= 1; --d) {
      const int o = loff[d], n = loff[d + 1] - o;
      FOR_LANES(l) {
        if (l < n) {
          const int i = lvl[o + l];
          const float* ax = tf + TF_JAXIS + 3 * i;
          float Ia[36], pAi[6];
          load16(BODY(i, IA), Ia, 36);
          for (int k = 0; k < 6; ++k) pAi[k] = BODY(i, PA)[k];
          for (int k = coff[i]; k < coff[i + 1]; ++k) add_child(CX + GC_STR * clist[k], Ia, pAi);
          float Ui[6], Ud[6];
          for (int a = 0; a < 6; ++a)
            Ui[a] = Ia[6 * a] * ax[0] + Ia[6 * a + 1] * ax[1] + Ia[6 * a + 2] * ax[2];
          const float di = Ui[0] * ax[0] + Ui[1] * ax[1] + Ui[2] * ax[2] + tf[TF_ARM + i - 1]
                           + dt * jdamp;
          const float dv = FDIV(1.f, di);
          const float ui = (tau[i - 1] - jdamp * s[JV + i - 1])
                           - (pAi[0] * ax[0] + pAi[1] * ax[1] + pAi[2] * ax[2]);
          for (int a = 0; a < 6; ++a) { BODY(i, U)[a] = Ui[a]; Ud[a] = Ui[a] * dv; }
          *BODY(i, DINV) = dv;
          *BODY(i, UU) = ui;
          for (int a = 0; a < 6; ++a)
            for (int c = a; c < 6; ++c) {
              Ia[6 * a + c] = Ia[6 * a + c] - Ui[a] * Ud[c];
              Ia[6 * c + a] = Ia[6 * a + c];
            }
          float pa[6];
          const float* cb = BODY(i, CB);
          for (int a = 0; a < 6; ++a) {
            float Ic = 0.f;
            for (int k = 0; k < 6; ++k) Ic += Ia[6 * a + k] * cb[k];
            pa[a] = (pAi[a] + Ic) + Ud[a] * ui;
          }
          child_terms(BODY(i, E), tf + TF_JPOS + 3 * i, Ia, pa, CX + GC_STR * i);
        }
      }
      SYNC();
    }

    // ---- base (one lane): add its children's terms, solve (IA0 + 1e-6 I) a0 =
    // -pA0 by Cholesky ----
    FOR_LANES(l) {
      if (l == 0) {
        // the factor L overwrites the lower triangle of M6 as it is formed
        float M6[36], inv[6], y[6], x[6], p0[6];
        load16(BODY(0, IA), M6, 36);
        for (int k = 0; k < 6; ++k) p0[k] = BODY(0, PA)[k];
        for (int k = coff[0]; k < coff[1]; ++k) add_child(CX + GC_STR * clist[k], M6, p0);
        float* L6 = M6;
        for (int j = 0; j < 6; ++j) {
          float acc = M6[7 * j] + 1e-6f;
          for (int k = 0; k < j; ++k) acc -= L6[6 * j + k] * L6[6 * j + k];
          L6[7 * j] = sqrtf(fmaxf(acc, 1e-12f));
          inv[j] = FDIV(1.f, L6[7 * j]);
          for (int i = j + 1; i < 6; ++i) {
            float acc2 = M6[6 * i + j];
            for (int k = 0; k < j; ++k) acc2 -= L6[6 * i + k] * L6[6 * j + k];
            L6[6 * i + j] = acc2 * inv[j];
          }
        }
        for (int i = 0; i < 6; ++i) {
          float acc = -p0[i];
          for (int k = 0; k < i; ++k) acc -= L6[6 * i + k] * y[k];
          y[i] = acc * inv[i];
        }
        for (int i = 5; i >= 0; --i) {
          float acc = y[i];
          for (int k = i + 1; k < 6; ++k) acc -= L6[6 * k + i] * x[k];
          x[i] = acc * inv[i];
        }
        for (int k = 0; k < 6; ++k) BODY(0, AC)[k] = x[k];
      }
    }
    SYNC();

    // ---- forward sweep: each body (one per lane) walks its path from the
    // base's acceleration in registers: a_j = X_j a_par + c_j + S_j qdd_j,
    // qdd_j = (u_j - U_j . (X_j a_par + c_j)) / D_j ----
    FOR_LANES(l) {
      if (l > 0 && l < nb) {
        float Aw[6];
        for (int k = 0; k < 6; ++k) Aw[k] = BODY(0, AC)[k];
        const int dl = depth[l];
        float qi = 0.f;
        for (int st = 1; st <= dl; ++st) {
          int j = l;                                   // the ancestor of l at depth st
          for (int u = dl; u > st; --u) j = ti[TI_PARENT + j];
          const float* ax = tf + TF_JAXIS + 3 * j;
          float Aj[6];
          xmot_T(BODY(j, E), tf + TF_JPOS + 3 * j, Aw, Aj);
          for (int a = 0; a < 6; ++a) Aj[a] += BODY(j, CB)[a];
          float ua = 0.f;
          for (int a = 0; a < 6; ++a) ua += BODY(j, U)[a] * Aj[a];
          qi = (*BODY(j, UU) - ua) * *BODY(j, DINV);
          for (int k = 0; k < 3; ++k) Aj[k] += ax[k] * qi;
          for (int a = 0; a < 6; ++a) Aw[a] = Aj[a];
        }
        for (int a = 0; a < 6; ++a) BODY(l, AC)[a] = Aw[a];
        qdd[l - 1] = qi;
      }
    }
    SYNC();

    // ---- report (last substep: geom forces, foot kinematics) and
    // semi-implicit Euler integration (joints one per lane, base on the last lane) ----
    FOR_LANES(l) {
      if (last) {
        for (int g = l; g < ng; g += GROUP) {
          const int b = ti[TI_GBODY + g];
          const float* go = tf + TF_GOFF + 3 * g;
          const float* st = gst + GS * g;
          const float* w = BODY(b, V);
          const float* Ab = BODY(b, AC);
          float t1[3], t2[3], t3[3], apt[3], aw[3];
          cross3(w, w + 3, t1);
          cross3(Ab, go, t2);
          cross3(w, go, t3);
          cross3(w, t3, t3);
          for (int k = 0; k < 3; ++k) apt[k] = Ab[3 + k] + t1[k] + t2[k] + t3[k];
          m3vec(BODY(b, R), apt, aw);
          float vx = st[0] + dt * aw[0], vy = st[1] + dt * aw[1], vz = st[2] + dt * aw[2];
          if constexpr (ROUGH) {
            // (f_el - D v_new) on active contacts, D = kt I + kdm n n^T
            const float* n = st + 6;
            float vnn = vx * n[0] + vy * n[1] + vz * n[2];
            float act_ = st[11];
            gf[3 * g + 0] = (st[3] - (st[9] * vx + st[10] * vnn * n[0])) * act_;
            gf[3 * g + 1] = (st[4] - (st[9] * vy + st[10] * vnn * n[1])) * act_;
            gf[3 * g + 2] = (st[5] - (st[9] * vz + st[10] * vnn * n[2])) * act_;
          } else {
            float act_ = st[6];
            gf[3 * g + 0] = (st[7] - st[4] * vx) * act_;
            gf[3 * g + 1] = (st[8] - st[4] * vy) * act_;
            gf[3 * g + 2] = (st[3] - (st[4] + st[5]) * vz) * act_;
          }
        }
        if (l < nf) {
          const int b = ti[TI_GBODY + ti[TI_FGEOM + l]];
          const float* off = tf + TF_FOFF + 3 * l;
          float tmp[3], vb[3];
          m3vec(BODY(b, R), off, tmp);
          for (int k = 0; k < 3; ++k) fpos[3 * l + k] = BODY(b, P)[k] + tmp[k];
          cross3(BODY(b, V), off, tmp);
          for (int k = 0; k < 3; ++k) vb[k] = BODY(b, V)[3 + k] + tmp[k];
          m3vec(BODY(b, R), vb, fvel + 3 * l);
        }
      }
      if (l < nj) {
        const float vl = tf[TF_VLIM + l];
        const float jv = fminf(fmaxf(s[JV + l] + dt * qdd[l], -vl), vl);
        s[JV + l] = jv;
        s[7 + l] += dt * jv;
      }
      if (l == GROUP - 1) {
        float* pos = s;
        float* q = s + 3;
        float* lv = s + LV;
        float* av = s + AV;
        float R0a[3], R0w[3], acl[3], wxv[3];
        const float *V0 = BODY(0, V), *A0 = BODY(0, AC), *R0 = BODY(0, R);
        cross3(V0, V0 + 3, wxv);
        for (int k = 0; k < 3; ++k) acl[k] = A0[3 + k] + wxv[k];
        m3vec(R0, acl, R0a);
        m3vec(R0, A0, R0w);
        float nw[3];
        for (int k = 0; k < 3; ++k) {
          lv[k] = fminf(fmaxf(lv[k] + dt * R0a[k], -100.f), 100.f);
          nw[k] = fminf(fmaxf(av[k] + dt * R0w[k], -100.f), 100.f);
          av[k] = nw[k];
        }
        for (int k = 0; k < 3; ++k) pos[k] += dt * lv[k];
        float wn = sqrtf(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2]);
        float inv = FDIV(1.f, fmaxf(wn, 1e-9f));
        float half = 0.5f * (wn * dt);
        float sh = sinf(half), ch = cosf(half);
        float dxq = nw[0] * inv * sh, dyq = nw[1] * inv * sh, dzq = nw[2] * inv * sh, dwq = ch;
        float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
        float nqx = dwq * qx + dxq * qw + dyq * qz - dzq * qy;
        float nqy = dwq * qy - dxq * qz + dyq * qw + dzq * qx;
        float nqz = dwq * qz + dxq * qy - dyq * qx + dzq * qw;
        float nqw = dwq * qw - dxq * qx - dyq * qy - dzq * qz;
        float qn = fmaxf(sqrtf(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw), 1e-9f);
        const float iqn = FDIV(1.f, qn);
        q[0] = nqx * iqn; q[1] = nqy * iqn; q[2] = nqz * iqn; q[3] = nqw * iqn;
      }
    }
    SYNC();
  }
#undef BODY
}

// Shared memory of one block: ENVS_PER_BLOCK workspaces and a copy of the tables.
PHYS_HD int block_shared_bytes(int ws_bytes) {
  return ENVS_PER_BLOCK * ws_bytes + 4 * (TF_SIZE + TI_FULL);
}

extern "C" {
// Bytes of one env's workspace (shared memory) for a model of these sizes.
int physics_workspace_bytes(int nb, int nj, int ng, int nf, int rough) {
  return 4 * ws_layout(nb, nj, ng, nf, rough != 0).words;
}
// Entries of the int table with its schedule (TI_FULL).
int physics_int_table_size() { return TI_FULL; }
}  // extern "C"

#ifdef __CUDACC__
// One warp per env, ENVS_PER_BLOCK envs per block, the tail block masked.
// ROUGH = false is B1 (flat ground, `tex` unused), true is B2 (heightfield `tex`).
template <bool ROUGH>
__global__ void __launch_bounds__(GROUP * ENVS_PER_BLOCK, BLOCKS_PER_SM(ROUGH)) decimated_step_kernel(
    const float* __restrict__ state_in, const float* __restrict__ act,
    const float* __restrict__ fric, const float* __restrict__ delta,
    const float* __restrict__ tf, const int* __restrict__ ti, const float4* __restrict__ tex,
    float* __restrict__ state_out, float* __restrict__ tau_out, float* __restrict__ gf_out,
    float* __restrict__ fpos_out, float* __restrict__ fvel_out, int B) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  PROF_STAMP();
  const int nj = ti[TI_NJ], ng = ti[TI_NG], nf = ti[TI_NF];
  const WsLayout L = ws_layout(ti[TI_NB], nj, ng, nf, ROUGH);
  unsigned dyn;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((unsigned)block_shared_bytes(4 * L.words) > dyn) __trap();   // workspace size not set
  float* tfs = smem + ENVS_PER_BLOCK * L.words;
  int* tis = reinterpret_cast<int*>(tfs + TF_SIZE);
  const int NS = 13 + 2 * nj + 2 * ng;
  const int e0 = blockIdx.x * ENVS_PER_BLOCK;
  const int ne = min(ENVS_PER_BLOCK, B - e0);
  const float ascale = tf[TF_ASCALE];
  const int tid = threadIdx.x;
  constexpr int NT = GROUP * ENVS_PER_BLOCK;
  // the tables, and the envs' inputs with the env index fastest, so
  // neighbouring threads read neighbouring addresses (the loops unrolled, so
  // each thread has its loads in flight together)
  // (torch's allocations and the workspaces keep both copies 16-byte aligned)
#pragma unroll
  for (int x = tid; x < TF_SIZE / 4; x += NT)
    reinterpret_cast<float4*>(tfs)[x] = LDG(reinterpret_cast<const float4*>(tf) + x);
  if (tid < TF_SIZE % 4) tfs[TF_SIZE / 4 * 4 + tid] = tf[TF_SIZE / 4 * 4 + tid];
#pragma unroll
  for (int x = tid; x < TI_FULL; x += NT) tis[x] = ti[x];
#pragma unroll 8
  for (int x = tid; x < NS * ENVS_PER_BLOCK; x += NT) {
    const int r = x / ENVS_PER_BLOCK, k = x % ENVS_PER_BLOCK;
    if (k < ne) smem[k * L.words + L.S + r] = state_in[(size_t)r * B + e0 + k];
  }
#pragma unroll 4
  for (int x = tid; x < nj * ENVS_PER_BLOCK; x += NT) {
    const int j = x / ENVS_PER_BLOCK, k = x % ENVS_PER_BLOCK;
    if (k < ne) smem[k * L.words + L.ACT + j] = act[(size_t)j * B + e0 + k] * ascale;
  }
  if (tid < ne) {
    smem[tid * L.words + L.FRIC] = fric[e0 + tid];
    smem[tid * L.words + L.DELTA] = delta[e0 + tid];
  }
  __syncthreads();
  PROF_STAMP();
  const int w = tid / GROUP;
  if (w < ne) env_control_step<ROUGH>(tfs, tis, tex, smem + w * L.words);
  __syncthreads();
  PROF_STAMP();
  // stage out
  for (int x = tid; x < NS * ENVS_PER_BLOCK; x += NT) {
    const int r = x / ENVS_PER_BLOCK, k = x % ENVS_PER_BLOCK;
    if (k < ne) state_out[(size_t)r * B + e0 + k] = smem[k * L.words + L.S + r];
  }
  for (int x = tid; x < nj * ENVS_PER_BLOCK; x += NT) {
    const int j = x / ENVS_PER_BLOCK, k = x % ENVS_PER_BLOCK;
    if (k < ne) tau_out[(size_t)j * B + e0 + k] = smem[k * L.words + L.TAU + j];
  }
  for (int x = tid; x < 3 * ng * ENVS_PER_BLOCK; x += NT) {
    const int r = x / ENVS_PER_BLOCK, k = x % ENVS_PER_BLOCK;
    if (k < ne) gf_out[(size_t)r * B + e0 + k] = smem[k * L.words + L.GF + r];
  }
  for (int x = tid; x < 3 * nf * ENVS_PER_BLOCK; x += NT) {
    const int r = x / ENVS_PER_BLOCK, k = x % ENVS_PER_BLOCK;
    if (k < ne) {
      fpos_out[(size_t)r * B + e0 + k] = smem[k * L.words + L.FP + r];
      fvel_out[(size_t)r * B + e0 + k] = smem[k * L.words + L.FV + r];
    }
  }
  PROF_STAMP();
}

static int g_ws_bytes = 0;   // one env's workspace, set by physics_set_workspace_bytes

extern "C" {

// Table layout for the wrapper's check: MAX_NB, MAX_NJ, MAX_NG, MAX_NF, TI_SIZE, TF_SIZE.
int physics_table_layout(int* out) {
  out[0] = MAX_NB; out[1] = MAX_NJ; out[2] = MAX_NG; out[3] = MAX_NF;
  out[4] = TI_SIZE; out[5] = TF_SIZE;
  return 0;
}

// Set the per-env workspace (bytes, physics_workspace_bytes of the model) of
// the next launches; a block (ENVS_PER_BLOCK workspaces and the tables) above
// 48 KB raises both kernels' dynamic shared-memory limit.  Returns a cudaError_t.
int physics_set_workspace_bytes(int bytes) {
  if (bytes == g_ws_bytes) return 0;
  if (bytes <= 0) return (int)cudaErrorInvalidValue;
  const int block = block_shared_bytes(bytes);
  if (block > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decimated_step_kernel<false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, block);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(decimated_step_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, block);
    if (err != cudaSuccess) return (int)err;
  }
  g_ws_bytes = bytes;
  return 0;
}

// One flat control step (B1) for B envs on `stream`.  All pointers are device
// pointers to contiguous float32 (int32 for ti) SoA arrays [rows, B].  Returns
// the launch's cudaGetLastError().
int physics_decimated_step(const float* state_in, const float* act, const float* fric,
                           const float* delta, const float* tf, const int* ti,
                           float* state_out, float* tau_out, float* gf_out, float* fpos_out,
                           float* fvel_out, int B, void* stream) {
  if (B <= 0) return 0;
  if (g_ws_bytes <= 0) return (int)cudaErrorInvalidValue;
  decimated_step_kernel<false><<<(B + ENVS_PER_BLOCK - 1) / ENVS_PER_BLOCK,
                                 GROUP * ENVS_PER_BLOCK, block_shared_bytes(g_ws_bytes),
                                 (cudaStream_t)stream>>>(
      state_in, act, fric, delta, tf, ti, nullptr, state_out, tau_out, gf_out, fpos_out,
      fvel_out, B);
  return (int)cudaGetLastError();
}

// One rough control step (B2): as physics_decimated_step, plus `tex`, the
// corner-packed heightfield [H*W, 4] float32 (16-byte aligned), whose H, W,
// spacing and origin are in the tables.
int physics_decimated_step_rough(const float* state_in, const float* act, const float* fric,
                                 const float* delta, const float* tf, const int* ti,
                                 const float* tex, float* state_out, float* tau_out,
                                 float* gf_out, float* fpos_out, float* fvel_out, int B,
                                 void* stream) {
  if (B <= 0) return 0;
  if (g_ws_bytes <= 0) return (int)cudaErrorInvalidValue;
  decimated_step_kernel<true><<<(B + ENVS_PER_BLOCK - 1) / ENVS_PER_BLOCK,
                                GROUP * ENVS_PER_BLOCK, block_shared_bytes(g_ws_bytes),
                                (cudaStream_t)stream>>>(
      state_in, act, fric, delta, tf, ti, reinterpret_cast<const float4*>(tex), state_out,
      tau_out, gf_out, fpos_out, fvel_out, B);
  return (int)cudaGetLastError();
}

#ifdef PHYS_PROFILE
// Copy the phase stamps of the last launches out (at most n) and clear them;
// returns how many there were.
int physics_profile_read(long long* out, int n) {
  int have = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(&have, phys_prof_n, sizeof(int));
  if (have > n) have = n;
  if (have > 0) cudaMemcpyFromSymbol(out, phys_prof, have * sizeof(long long));
  const int zero = 0;
  cudaMemcpyToSymbol(phys_prof_n, &zero, sizeof(int));
  return have;
}
#endif

}  // extern "C"
#endif
