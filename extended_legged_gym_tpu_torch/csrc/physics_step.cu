// Fused, decimated flat-terrain physics step for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel B1: extended_legged_gym_tpu/ops/physics_kernel.py,
// build_physics_kernel(rough=False) (kernel body :136-419, pallas_call :447),
// as driven by make_decimated_env_step (:626-735).  One launch advances B
// environments by one CONTROL step: for each of `decimation` substeps it
// computes the PD (or direct) torques and runs one semi-implicit-Euler ABA
// step: forward kinematics and velocities, sphere-vs-plane penalty contacts
// (depth clamp, no-adhesion kd cap, tangential damping, anchor stiction),
// implicit contact damper dt*Ds added to the articulated inertias, backward
// sweep, 6x6 Cholesky base solve, forward sweep, clamped integration with an
// exp-map quaternion.  The last substep also reports the contact force on every
// geom (implicit-consistent, post-step point velocities) and foot kinematics.
// Its plain version is physics/aba.py (aba_physics_step), run once per
// substep; the wrapper is ops/physics_kernel.py.
//
// Design: one thread per environment over SoA [rows, B] tensors, any B, the
// tail masked, in blocks of one warp, so B envs spread over B/32 SMs and each
// SM's L1 serves fewer of the per-thread stacks; __launch_bounds__(32, 1) lets
// ptxas keep ~150 registers per thread (left to itself it chose 64 and spilled).  The model (tree, joint frames, spatial inertias, geoms, gains,
// contact and sim parameters) comes in as two small device tables, one of
// floats and one of ints, laid out by the offsets below (mirrored in
// ops/physics_kernel.py).  Loops run to the model's sizes under fixed
// compile-time maxima, so one build serves every robot and nvcc takes
// seconds.  Per-thread working arrays (13 articulated inertias of 36 floats,
// geom stashes, ...) live in local memory.
//
// What bounds it on an H100: for ANYmal-C one env's control step needs
// ~8.9e4 float operations (~2.2e4 per substep, counted blockwise in
// ops/physics_kernel.py:control_step_flops) and moves ~1.5 KB of state and
// outputs, so at the main path's B = 8..2048 envs a launch is at most ~2e8
// operations and ~3 MB: the card's rate bounds (67 TFLOP/s float32,
// 3.35 TB/s) put it at a few microseconds.  It is not near them.  With one
// thread per env, B = 2048 fills 64 of the 132 SMs with one warp each, and
// each thread walks a serial chain of dependent float operations through its
// 16 KB local-memory stack.  Latency bounds it: instruction and local-memory
// latency with one warp per SM.
// A later design spreads one env over a warp or a few threads (one thread per
// leg for the per-body sweeps, lanes for the 6x6 blocks), stages the
// articulated inertias in shared memory instead of local memory, and batches
// several control steps of a rollout into one launch.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PHYS_HD __host__ __device__ __forceinline__
#else
#define PHYS_HD inline
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
#define TI_PARENT 8
#define TI_GBODY (TI_PARENT + MAX_NB)
#define TI_FGEOM (TI_GBODY + MAX_NG)
#define TI_SIZE (TI_FGEOM + MAX_NF)

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
#define TF_SIZE (TF_FOFF + MAX_NF * 3)

// ---------------------------------------------------------------- small math
PHYS_HD void m3mul(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}
PHYS_HD void m3vec(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}
PHYS_HD void m3Tvec(const float* A, const float* v, float* o) {
  for (int i = 0; i < 3; ++i) o[i] = A[i] * v[0] + A[3 + i] * v[1] + A[6 + i] * v[2];
}
PHYS_HD void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}
PHYS_HD void m6vec(const float* M, const float* v, float* o) {
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
    for (int k = 0; k < 6; ++k) acc += M[6 * i + k] * v[k];
    o[i] = acc;
  }
}
// spatial force cross product v x* f = [w x fn + l x fl, w x fl]
PHYS_HD void cross_force(const float* v, const float* f, float* o) {
  float a[3], b[3], c[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  cross3(v, f + 3, c);
  for (int k = 0; k < 3; ++k) { o[k] = a[k] + b[k]; o[3 + k] = c[k]; }
}
// motion transform parent -> child with child rotation E^T: [E^T w, E^T (l - r x w)]
PHYS_HD void xmot_T(const float* E, const float* r, const float* v, float* o) {
  float rw[3], d[3];
  cross3(r, v, rw);
  for (int k = 0; k < 3; ++k) d[k] = v[3 + k] - rw[k];
  m3Tvec(E, v, o);
  m3Tvec(E, d, o + 3);
}
// force transform child -> parent for child rotation E^T: [E n + r x (E fl), E fl]
PHYS_HD void xforce(const float* E, const float* r, const float* f, float* o) {
  float n[3], fl[3], rf[3];
  m3vec(E, f, n);
  m3vec(E, f + 3, fl);
  cross3(r, fl, rf);
  for (int k = 0; k < 3; ++k) { o[k] = n[k] + rf[k]; o[3 + k] = fl[k]; }
}
// O = E S E^T for a symmetric 3x3 S (upper triangle computed, then mirrored)
PHYS_HD void rot_sym(const float* E, const float* S, float* O) {
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
PHYS_HD void rot_gen(const float* E, const float* M, float* O) {
  float T[9];  // M E^T
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      T[3 * i + j] = M[3 * i] * E[3 * j] + M[3 * i + 1] * E[3 * j + 1] + M[3 * i + 2] * E[3 * j + 2];
  m3mul(E, T, O);
}
// IA_par += X^T Ia X with X = [[Et, 0], [-Et rx, Et]] = diag(Et, Et) [[I, 0], [-rx, I]],
// Et = E^T, done blockwise on the symmetric Ia = [[A, B], [B^T, D]], as the TPU
// kernel's xia_T is, so zero blocks and the zeros of rx are never multiplied:
// rotate A' = E A E^T, B' = E B E^T, D' = E D E^T, then shift by r,
//   X^T Ia X = [[A' - W - W^T - rx D' rx, B' + rx D'], [(B' + rx D')^T, D']],  W = B' rx.
PHYS_HD void add_xia(const float* E, const float* r, const float* Ia, float* IAp) {
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
  float W[9], rxD[9], col[3], Y[3];
  for (int i = 0; i < 3; ++i) {
    cross3(Br + 3 * i, r, W + 3 * i);  // row i of B' rx
    cross3(r, Dr + 3 * i, col);        // column i of rx D' (D' symmetric)
    for (int k = 0; k < 3; ++k) rxD[3 * k + i] = col[k];
  }
  for (int i = 0; i < 3; ++i) {
    cross3(rxD + 3 * i, r, Y);         // row i of rx D' rx
    for (int j = i; j < 3; ++j) {
      float a = Ar[3 * i + j] - W[3 * i + j] - W[3 * j + i] - Y[j];
      IAp[6 * i + j] += a;
      if (j != i) IAp[6 * j + i] += a;
    }
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float b = Br[3 * i + j] + rxD[3 * i + j];
      IAp[6 * i + 3 + j] += b;
      IAp[6 * (3 + j) + i] += b;
      IAp[6 * (3 + i) + 3 + j] += Dr[3 * i + j];
    }
}

// ---------------------------------------------------------------- per-env step
// State rows: [pos(3), quat(4), jpos(nj), lvel(3), avel(3), jvel(nj), anchors(2 ng)].
// `s` is this env's state (NS floats, updated in place); `act` the scaled
// actions; on the last substep the report goes to gf (3 ng), fpos, fvel (3 nf)
// and tau (nj).
PHYS_HD void env_control_step(const float* tf, const int* ti, float* s, const float* act,
                              float fric, float delta, float* tau_last, float* gf,
                              float* fpos, float* fvel) {
  const int nb = ti[TI_NB], nj = ti[TI_NJ], ng = ti[TI_NG], nf = ti[TI_NF];
  const int decim = ti[TI_DECIM], ctrl = ti[TI_CTRL];
  const float dt = tf[TF_DT], kp = tf[TF_KP], kd = tf[TF_KD], ktmax = tf[TF_KT];
  const float kts = tf[TF_KTS], jdamp = tf[TF_JDAMP], h0 = tf[TF_H0];
  const float mu = tf[TF_MU] * fric;
  const int LV = 7 + nj, AV = 10 + nj, JV = 13 + nj, AN = 13 + 2 * nj;

  float R[MAX_NB][9], P[MAX_NB][3], Ej[MAX_NB][9], V[MAX_NB][6], Cb[MAX_NB][6];
  float IA[MAX_NB][36], pA[MAX_NB][6], U[MAX_NB][6], dinv[MAX_NB], uu[MAX_NB], A[MAX_NB][6];
  float tau[MAX_NJ], gst[MAX_NG][9];

  for (int sub = 0; sub < decim; ++sub) {
    const bool last = (sub == decim - 1);
    float* pos = s;
    float* q = s + 3;
    float* jq = s + 7;
    float* lv = s + LV;
    float* av = s + AV;
    float* jv = s + JV;

    // ---- torques ----
    for (int j = 0; j < nj; ++j) {
      float t = ctrl == 0
          ? tf[TF_PGAIN + j] * (act[j] + tf[TF_DDP + j] - jq[j]) - tf[TF_DGAIN + j] * jv[j]
          : act[j];
      float tl = tf[TF_TLIM + j];
      tau[j] = fminf(fmaxf(t, -tl), tl);
    }

    // ---- pass 1: kinematics + velocities ----
    {
      float x = q[0], y = q[1], z = q[2], w = q[3];
      float* R0 = R[0];
      R0[0] = 1.f - 2.f * (y * y + z * z); R0[1] = 2.f * (x * y - w * z); R0[2] = 2.f * (x * z + w * y);
      R0[3] = 2.f * (x * y + w * z); R0[4] = 1.f - 2.f * (x * x + z * z); R0[5] = 2.f * (y * z - w * x);
      R0[6] = 2.f * (x * z - w * y); R0[7] = 2.f * (y * z + w * x); R0[8] = 1.f - 2.f * (x * x + y * y);
      for (int k = 0; k < 3; ++k) P[0][k] = pos[k];
      m3Tvec(R0, av, V[0]);
      m3Tvec(R0, lv, V[0] + 3);
    }
    for (int i = 1; i < nb; ++i) {
      const int par = ti[TI_PARENT + i];
      const float* ax = tf + TF_JAXIS + 3 * i;
      const float* r = tf + TF_JPOS + 3 * i;
      // Rodrigues: Rq = I + sin K + (1 - cos) K^2, K = [ax]x, K^2 = ax ax^T - |ax|^2 I
      float c = cosf(jq[i - 1]), sn = sinf(jq[i - 1]), oc = 1.f - c;
      float dg = 1.f - oc * (ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]);
      float oxy = oc * ax[0] * ax[1], oxz = oc * ax[0] * ax[2], oyz = oc * ax[1] * ax[2];
      float Rq[9] = {dg + oc * ax[0] * ax[0], oxy - sn * ax[2], oxz + sn * ax[1],
                     oxy + sn * ax[2], dg + oc * ax[1] * ax[1], oyz - sn * ax[0],
                     oxz - sn * ax[1], oyz + sn * ax[0], dg + oc * ax[2] * ax[2]};
      m3mul(tf + TF_JROT + 9 * i, Rq, Ej[i]);
      m3mul(R[par], Ej[i], R[i]);
      float pr[3];
      m3vec(R[par], r, pr);
      for (int k = 0; k < 3; ++k) P[i][k] = P[par][k] + pr[k];
      float thd = jv[i - 1];
      float vj[3] = {ax[0] * thd, ax[1] * thd, ax[2] * thd};
      xmot_T(Ej[i], r, V[par], V[i]);
      for (int k = 0; k < 3; ++k) V[i][k] += vj[k];
      cross3(V[i], vj, Cb[i]);
      cross3(V[i] + 3, vj, Cb[i] + 3);
    }

    // ---- articulated inertias + velocity-product biases (nominal inertia) ----
    for (int i = 0; i < nb; ++i) {
      for (int k = 0; k < 36; ++k) IA[i][k] = tf[TF_ISP + 36 * i + k];
      if (i == 0)
        for (int k = 0; k < 36; ++k) IA[0][k] += delta * tf[TF_IUNIT0 + k];
      float Iv[6];
      m6vec(IA[i], V[i], Iv);
      cross_force(V[i], Iv, pA[i]);
    }

    // ---- contacts: forces into pA, implicit dampers into IA ----
    for (int g = 0; g < ng; ++g) {
      const int b = ti[TI_GBODY + g];
      const float* go = tf + TF_GOFF + 3 * g;
      const float rad = tf[TF_GRAD + g];
      float gp[3], gvb[3], gv[3], tmp[3];
      m3vec(R[b], go, tmp);
      for (int k = 0; k < 3; ++k) gp[k] = P[b][k] + tmp[k];
      cross3(V[b], go, tmp);
      for (int k = 0; k < 3; ++k) gvb[k] = V[b][3 + k] + tmp[k];
      m3vec(R[b], gvb, gv);

      float depth = (h0 + rad) - gp[2];
      float active = depth > 0.f ? 1.f : 0.f;
      float depth_a = fminf(fmaxf(depth, 0.f), 2.f * rad + 0.05f);
      float vn = gv[2];
      float vt_norm = sqrtf(gv[0] * gv[0] + gv[1] * gv[1]);
      float fn_el = kp * depth_a;
      float kd_g = fminf(kd, fn_el / fmaxf(vn, 1e-6f));
      float fn_est = fmaxf(fn_el - kd_g * vn, 0.f) * active;
      float kt_eff = fminf(ktmax, mu * fn_est / fmaxf(vt_norm, 1e-3f));
      float* anc = s + AN + 2 * g;
      float dx = gp[0] - anc[0], dy = gp[1] - anc[1];
      float dn = sqrtf(dx * dx + dy * dy);
      float budget = fmaxf(mu * fn_est - kt_eff * vt_norm, 0.f);
      float cf = fminf(1.f, budget / fmaxf(kts * dn, 1e-9f));
      float fsx = -kts * cf * active * dx, fsy = -kts * cf * active * dy;
      float kt_a = kt_eff * active, kdm = (kd_g - kt_eff) * active;
      float fz_el = fn_el * active;
      if (active > 0.f) { anc[0] = gp[0] - cf * dx; anc[1] = gp[1] - cf * dy; }
      else { anc[0] = gp[0]; anc[1] = gp[1]; }
      float* st = gst[g];
      st[0] = gv[0]; st[1] = gv[1]; st[2] = gv[2];
      st[3] = fz_el; st[4] = kt_a; st[5] = kdm; st[6] = active; st[7] = fsx; st[8] = fsy;

      // explicit force f_el - D v (n = z), into body coords at the body origin
      float fw[3] = {fsx - kt_a * gv[0], fsy - kt_a * gv[1], fz_el - (kt_a + kdm) * gv[2]};
      float fb[3], nfb[3];
      m3Tvec(R[b], fw, fb);
      cross3(go, fb, nfb);
      for (int k = 0; k < 3; ++k) { pA[b][k] -= nfb[k]; pA[b][3 + k] -= fb[k]; }
      // implicit damper dt Ds, Ds = [[rx D rx^T, rx D], [D rx^T, D]], with
      // D = kt I + kdm n n^T in body coords (n = R^T z, the third row of R), so
      // rx D rx^T = kt (|r|^2 I - r r^T) + kdm m m^T and rx D = kt rx + kdm m n^T, m = r x n
      const float* nz = R[b] + 6;
      float m[3];
      cross3(go, nz, m);
      const float kt_d = dt * kt_a, kd_d = dt * kdm;
      const float rr = go[0] * go[0] + go[1] * go[1] + go[2] * go[2];
      const float rx[9] = {0.f, -go[2], go[1], go[2], 0.f, -go[0], -go[1], go[0], 0.f};
      for (int a = 0; a < 3; ++a)
        for (int c2 = a; c2 < 3; ++c2) {
          float tl = kt_d * ((a == c2 ? rr : 0.f) - go[a] * go[c2]) + kd_d * m[a] * m[c2];
          float br = (a == c2 ? kt_d : 0.f) + kd_d * nz[a] * nz[c2];
          IA[b][6 * a + c2] += tl;
          IA[b][6 * (3 + a) + 3 + c2] += br;
          if (c2 != a) { IA[b][6 * c2 + a] += tl; IA[b][6 * (3 + c2) + 3 + a] += br; }
        }
      for (int a = 0; a < 3; ++a)
        for (int c2 = 0; c2 < 3; ++c2) {
          float tr = kt_d * rx[3 * a + c2] + kd_d * m[a] * nz[c2];
          IA[b][6 * a + 3 + c2] += tr;
          IA[b][6 * (3 + c2) + a] += tr;
        }
    }

    // ---- explicit gravity ----
    for (int i = 0; i < nb; ++i) {
      float m = tf[TF_MASS + i] + (i == 0 ? delta : 0.f);
      float gb_[3], fg[3], cf_[3];
      m3Tvec(R[i], tf + TF_G, gb_);
      for (int k = 0; k < 3; ++k) fg[k] = m * gb_[k];
      cross3(tf + TF_COM + 3 * i, fg, cf_);
      for (int k = 0; k < 3; ++k) { pA[i][k] -= cf_[k]; pA[i][3 + k] -= fg[k]; }
    }

    // ---- backward sweep ----
    for (int i = nb - 1; i > 0; --i) {
      const int par = ti[TI_PARENT + i];
      const float* ax = tf + TF_JAXIS + 3 * i;
      const float* r = tf + TF_JPOS + 3 * i;
      for (int a = 0; a < 6; ++a)
        U[i][a] = IA[i][6 * a] * ax[0] + IA[i][6 * a + 1] * ax[1] + IA[i][6 * a + 2] * ax[2];
      float di = U[i][0] * ax[0] + U[i][1] * ax[1] + U[i][2] * ax[2] + tf[TF_ARM + i - 1] + dt * jdamp;
      dinv[i] = 1.f / di;
      float tau_i = tau[i - 1] - jdamp * jv[i - 1];
      uu[i] = tau_i - (pA[i][0] * ax[0] + pA[i][1] * ax[1] + pA[i][2] * ax[2]);
      float Ud[6], Ia[36];  // Ia = IA - U U^T / d, symmetric
      for (int a = 0; a < 6; ++a) Ud[a] = U[i][a] * dinv[i];
      for (int a = 0; a < 6; ++a)
        for (int c2 = a; c2 < 6; ++c2) {
          Ia[6 * a + c2] = IA[i][6 * a + c2] - U[i][a] * Ud[c2];
          Ia[6 * c2 + a] = Ia[6 * a + c2];
        }
      float pa[6], Ic[6], fpar[6];
      m6vec(Ia, Cb[i], Ic);
      for (int a = 0; a < 6; ++a) pa[a] = pA[i][a] + Ic[a] + Ud[a] * uu[i];
      add_xia(Ej[i], r, Ia, IA[par]);
      xforce(Ej[i], r, pa, fpar);
      for (int a = 0; a < 6; ++a) pA[par][a] += fpar[a];
    }

    // ---- base: solve (IA0 + 1e-6 I) a0 = -pA0 by Cholesky ----
    {
      float L[36], y[6];
      for (int k = 0; k < 36; ++k) L[k] = 0.f;
      for (int j = 0; j < 6; ++j) {
        float acc = IA[0][7 * j] + 1e-6f;
        for (int k = 0; k < j; ++k) acc -= L[6 * j + k] * L[6 * j + k];
        L[7 * j] = sqrtf(fmaxf(acc, 1e-12f));
        for (int i = j + 1; i < 6; ++i) {
          float acc2 = IA[0][6 * i + j];
          for (int k = 0; k < j; ++k) acc2 -= L[6 * i + k] * L[6 * j + k];
          L[6 * i + j] = acc2 / L[7 * j];
        }
      }
      for (int i = 0; i < 6; ++i) {
        float acc = -pA[0][i];
        for (int k = 0; k < i; ++k) acc -= L[6 * i + k] * y[k];
        y[i] = acc / L[7 * i];
      }
      for (int i = 5; i >= 0; --i) {
        float acc = y[i];
        for (int k = i + 1; k < 6; ++k) acc -= L[6 * k + i] * A[0][k];
        A[0][i] = acc / L[7 * i];
      }
    }

    // ---- forward sweep ----
    float qdd[MAX_NJ];
    for (int i = 1; i < nb; ++i) {
      const int par = ti[TI_PARENT + i];
      const float* ax = tf + TF_JAXIS + 3 * i;
      xmot_T(Ej[i], tf + TF_JPOS + 3 * i, A[par], A[i]);
      for (int a = 0; a < 6; ++a) A[i][a] += Cb[i][a];
      float ua = 0.f;
      for (int a = 0; a < 6; ++a) ua += U[i][a] * A[i][a];
      float qi = (uu[i] - ua) * dinv[i];
      for (int k = 0; k < 3; ++k) A[i][k] += ax[k] * qi;
      qdd[i - 1] = qi;
    }

    // ---- report (last substep): foot kinematics, geom forces ----
    if (last) {
      for (int j = 0; j < nj; ++j) tau_last[j] = tau[j];
      for (int f = 0; f < nf; ++f) {
        const int b = ti[TI_GBODY + ti[TI_FGEOM + f]];
        const float* off = tf + TF_FOFF + 3 * f;
        float tmp[3], vb[3];
        m3vec(R[b], off, tmp);
        for (int k = 0; k < 3; ++k) fpos[3 * f + k] = P[b][k] + tmp[k];
        cross3(V[b], off, tmp);
        for (int k = 0; k < 3; ++k) vb[k] = V[b][3 + k] + tmp[k];
        m3vec(R[b], vb, fvel + 3 * f);
      }
      for (int g = 0; g < ng; ++g) {
        const int b = ti[TI_GBODY + g];
        const float* go = tf + TF_GOFF + 3 * g;
        const float* st = gst[g];
        const float* w = V[b];
        float t1[3], t2[3], t3[3], apt[3], aw[3];
        cross3(w, V[b] + 3, t1);
        cross3(A[b], go, t2);
        cross3(w, go, t3);
        cross3(w, t3, t3);
        for (int k = 0; k < 3; ++k) apt[k] = A[b][3 + k] + t1[k] + t2[k] + t3[k];
        m3vec(R[b], apt, aw);
        float vx = st[0] + dt * aw[0], vy = st[1] + dt * aw[1], vz = st[2] + dt * aw[2];
        float act_ = st[6];
        gf[3 * g + 0] = (st[7] - st[4] * vx) * act_;
        gf[3 * g + 1] = (st[8] - st[4] * vy) * act_;
        gf[3 * g + 2] = (st[3] - (st[4] + st[5]) * vz) * act_;
      }
    }

    // ---- integrate (semi-implicit Euler) ----
    float R0a[3], R0w[3], acl[3], wxv[3];
    cross3(V[0], V[0] + 3, wxv);
    for (int k = 0; k < 3; ++k) acl[k] = A[0][3 + k] + wxv[k];
    m3vec(R[0], acl, R0a);
    m3vec(R[0], A[0], R0w);
    float nw[3];
    for (int k = 0; k < 3; ++k) {
      lv[k] = fminf(fmaxf(lv[k] + dt * R0a[k], -100.f), 100.f);
      nw[k] = fminf(fmaxf(av[k] + dt * R0w[k], -100.f), 100.f);
      av[k] = nw[k];
    }
    for (int j = 0; j < nj; ++j) {
      float vl = tf[TF_VLIM + j];
      jv[j] = fminf(fmaxf(jv[j] + dt * qdd[j], -vl), vl);
      jq[j] += dt * jv[j];
    }
    for (int k = 0; k < 3; ++k) pos[k] += dt * lv[k];
    float wn = sqrtf(nw[0] * nw[0] + nw[1] * nw[1] + nw[2] * nw[2]);
    float inv = 1.f / fmaxf(wn, 1e-9f);
    float half = 0.5f * (wn * dt);
    float sh = sinf(half), ch = cosf(half);
    float dxq = nw[0] * inv * sh, dyq = nw[1] * inv * sh, dzq = nw[2] * inv * sh, dwq = ch;
    float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
    float nqx = dwq * qx + dxq * qw + dyq * qz - dzq * qy;
    float nqy = dwq * qy - dxq * qz + dyq * qw + dzq * qx;
    float nqz = dwq * qz + dxq * qy - dyq * qx + dzq * qw;
    float nqw = dwq * qw - dxq * qx - dyq * qy - dzq * qz;
    float qn = fmaxf(sqrtf(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw), 1e-9f);
    q[0] = nqx / qn; q[1] = nqy / qn; q[2] = nqz / qn; q[3] = nqw / qn;
  }
}

#ifdef __CUDACC__
#define MAX_NS (13 + 2 * MAX_NJ + 2 * MAX_NG)

__global__ void __launch_bounds__(32, 1) decimated_step_kernel(
    const float* __restrict__ state_in, const float* __restrict__ act,
    const float* __restrict__ fric, const float* __restrict__ delta,
    const float* __restrict__ tf, const int* __restrict__ ti,
    float* __restrict__ state_out, float* __restrict__ tau_out, float* __restrict__ gf_out,
    float* __restrict__ fpos_out, float* __restrict__ fvel_out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int nj = ti[TI_NJ], ng = ti[TI_NG], nf = ti[TI_NF];
  const int NS = 13 + 2 * nj + 2 * ng;
  const float ascale = tf[TF_ASCALE];
  float s[MAX_NS], a[MAX_NJ], tau[MAX_NJ], gf[3 * MAX_NG], fp[3 * MAX_NF], fv[3 * MAX_NF];
  for (int r = 0; r < NS; ++r) s[r] = state_in[(size_t)r * B + e];
  for (int j = 0; j < nj; ++j) a[j] = act[(size_t)j * B + e] * ascale;
  env_control_step(tf, ti, s, a, fric[e], delta[e], tau, gf, fp, fv);
  for (int r = 0; r < NS; ++r) state_out[(size_t)r * B + e] = s[r];
  for (int j = 0; j < nj; ++j) tau_out[(size_t)j * B + e] = tau[j];
  for (int r = 0; r < 3 * ng; ++r) gf_out[(size_t)r * B + e] = gf[r];
  for (int r = 0; r < 3 * nf; ++r) {
    fpos_out[(size_t)r * B + e] = fp[r];
    fvel_out[(size_t)r * B + e] = fv[r];
  }
}

extern "C" {

// Table layout for the wrapper's check: MAX_NB, MAX_NJ, MAX_NG, MAX_NF, TI_SIZE, TF_SIZE.
int physics_table_layout(int* out) {
  out[0] = MAX_NB; out[1] = MAX_NJ; out[2] = MAX_NG; out[3] = MAX_NF;
  out[4] = TI_SIZE; out[5] = TF_SIZE;
  return 0;
}

// One control step for B envs on `stream`.  All pointers are device pointers
// to contiguous float32 (int32 for ti) SoA arrays [rows, B].  Returns the
// launch's cudaGetLastError().
int physics_decimated_step(const float* state_in, const float* act, const float* fric,
                           const float* delta, const float* tf, const int* ti,
                           float* state_out, float* tau_out, float* gf_out, float* fpos_out,
                           float* fvel_out, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32;
  decimated_step_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      state_in, act, fric, delta, tf, ti, state_out, tau_out, gf_out, fpos_out, fvel_out, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif
