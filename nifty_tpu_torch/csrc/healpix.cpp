// HEALPix pixelization core (ring + nested schemes), implemented from the
// published geometry (Górski et al. 2005, ApJ 622, 759): the sphere is
// covered by 12 base faces of nside^2 pixels; rings are indexed from the
// north pole; the nested scheme bit-interleaves within-face coordinates.
//
// This is the native backend of `nifty_tpu.ops.healpix` — batch C ABI
// functions over int64/double arrays, called through ctypes.  Neighbor
// finding is *geometric*: step a tiny epsilon beyond each edge midpoint /
// corner of the pixel in the face plane and locate the containing pixel —
// exact by construction, no face-adjacency tables, and returns -1 for the
// missing corner neighbor of the 7-neighbor pixels (healpy convention).

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

constexpr double PI = 3.14159265358979323846;

// North-to-south ring offset and phi offset of the 12 faces.
constexpr int jrll[12] = {2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4};
constexpr int jpll[12] = {1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7};

inline int64_t isqrt(int64_t v) {
  auto r = static_cast<int64_t>(std::sqrt(static_cast<double>(v) + 0.5));
  while (r * r > v) --r;
  while ((r + 1) * (r + 1) <= v) ++r;
  return r;
}

// Spread the lower 32 bits of x over the even bit positions.
inline int64_t spread_bits(int64_t x) {
  int64_t v = x & 0xffffffff;
  v = (v | (v << 16)) & 0x0000ffff0000ffffll;
  v = (v | (v << 8)) & 0x00ff00ff00ff00ffll;
  v = (v | (v << 4)) & 0x0f0f0f0f0f0f0f0fll;
  v = (v | (v << 2)) & 0x3333333333333333ll;
  v = (v | (v << 1)) & 0x5555555555555555ll;
  return v;
}

inline int64_t compress_bits(int64_t v) {
  v &= 0x5555555555555555ll;
  v = (v | (v >> 1)) & 0x3333333333333333ll;
  v = (v | (v >> 2)) & 0x0f0f0f0f0f0f0f0fll;
  v = (v | (v >> 4)) & 0x00ff00ff00ff00ffll;
  v = (v | (v >> 8)) & 0x0000ffff0000ffffll;
  v = (v | (v >> 16)) & 0x00000000ffffffffll;
  return v;
}

struct Xyf {
  int64_t ix, iy;
  int face;
};

inline Xyf nest2xyf(int64_t nside, int64_t pix) {
  int64_t npface = nside * nside;
  Xyf r;
  r.face = static_cast<int>(pix / npface);
  int64_t p = pix % npface;
  r.ix = compress_bits(p);
  r.iy = compress_bits(p >> 1);
  return r;
}

inline int64_t xyf2nest(int64_t nside, const Xyf &x) {
  return static_cast<int64_t>(x.face) * nside * nside + spread_bits(x.ix) +
         (spread_bits(x.iy) << 1);
}

// Within-face coordinates + face -> (z, phi).  fx, fy in [0, 1] are the
// continuous face coordinates ((ix + dx) / nside).
inline void xyf2loc(double fx, double fy, int face, double *z, double *phi) {
  double jr = jrll[face] - fx - fy;
  double nr;
  if (jr < 1.0) {            // north polar cap
    nr = jr;
    *z = 1.0 - nr * nr / 3.0;
  } else if (jr > 3.0) {     // south polar cap
    nr = 4.0 - jr;
    *z = nr * nr / 3.0 - 1.0;
  } else {                   // equatorial belt
    nr = 1.0;
    *z = (2.0 - jr) * 2.0 / 3.0;
  }
  double tmp = jpll[face] * nr + fx - fy;
  // NOTE: wrap phi (not tmp) — the tmp period is 8*nr, which equals 8
  // only in the equatorial belt.
  double ph = (nr < 1e-15) ? 0.0 : (PI / 4.0) * tmp / nr;
  ph = std::fmod(ph, 2 * PI);
  if (ph < 0) ph += 2 * PI;
  *phi = ph;
}

inline int64_t ang2pix_ring_one(int64_t nside, double theta, double phi) {
  double z = std::cos(theta);
  double za = std::fabs(z);
  double tt = std::fmod(phi, 2 * PI);
  if (tt < 0) tt += 2 * PI;
  tt /= (PI / 2);  // in [0, 4)
  int64_t npix = 12 * nside * nside;
  int64_t ncap = 2 * nside * (nside - 1);

  if (za <= 2.0 / 3.0) {  // equatorial region
    double temp1 = nside * (0.5 + tt);
    double temp2 = nside * z * 0.75;
    auto jp = static_cast<int64_t>(std::floor(temp1 - temp2));
    auto jm = static_cast<int64_t>(std::floor(temp1 + temp2));
    int64_t ir = nside + 1 + jp - jm;  // in {1, ..., 2 nside + 1}
    int64_t kshift = 1 - (ir & 1);
    int64_t t1 = jp + jm - nside + kshift + 1;
    int64_t ip = t1 / 2;
    ip %= 4 * nside;
    if (ip < 0) ip += 4 * nside;
    return ncap + (ir - 1) * 4 * nside + ip;
  }
  // polar caps
  double tp = tt - std::floor(tt);
  double tmp = nside * std::sqrt(3.0 * (1.0 - za));
  auto jp = static_cast<int64_t>(std::floor(tp * tmp));
  auto jm = static_cast<int64_t>(std::floor((1.0 - tp) * tmp));
  int64_t ir = jp + jm + 1;  // ring number counted from the closest pole
  auto ip = static_cast<int64_t>(std::floor(tt * ir));
  ip %= 4 * ir;
  if (ip < 0) ip += 4 * ir;
  if (z > 0) return 2 * ir * (ir - 1) + ip;
  return npix - 2 * ir * (ir + 1) + ip;
}

inline void pix2ang_ring_one(int64_t nside, int64_t pix, double *theta,
                             double *phi) {
  int64_t npix = 12 * nside * nside;
  int64_t ncap = 2 * nside * (nside - 1);
  if (pix < ncap) {  // north polar cap
    int64_t iring = (1 + isqrt(1 + 2 * pix)) >> 1;
    int64_t iphi = pix + 1 - 2 * iring * (iring - 1);
    *theta = std::acos(1.0 - iring * iring / (3.0 * nside * nside));
    *phi = (iphi - 0.5) * PI / (2.0 * iring);
  } else if (pix < npix - ncap) {  // equatorial
    int64_t ip = pix - ncap;
    int64_t iring = ip / (4 * nside) + nside;
    int64_t iphi = ip % (4 * nside) + 1;
    double fodd = ((iring + nside) & 1) ? 1.0 : 0.5;
    *theta = std::acos((2.0 * nside - iring) * 2.0 / (3.0 * nside));
    *phi = (iphi - fodd) * PI / (2.0 * nside);
  } else {  // south polar cap
    int64_t ip = npix - pix;
    int64_t iring = (1 + isqrt(2 * ip - 1)) >> 1;
    int64_t iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1));
    *theta = std::acos(-1.0 + iring * iring / (3.0 * nside * nside));
    *phi = (iphi - 0.5) * PI / (2.0 * iring);
  }
}

inline Xyf ring2xyf(int64_t nside, int64_t pix) {
  int64_t npix = 12 * nside * nside;
  int64_t ncap = 2 * nside * (nside - 1);
  int64_t iring, iphi, kshift, nr;
  int face;
  if (pix < ncap) {  // north polar cap
    iring = (1 + isqrt(1 + 2 * pix)) >> 1;
    iphi = pix + 1 - 2 * iring * (iring - 1);
    kshift = 0;
    nr = iring;
    face = static_cast<int>((iphi - 1) / nr);
  } else if (pix < npix - ncap) {  // equatorial
    int64_t ip = pix - ncap;
    iring = ip / (4 * nside) + nside;
    iphi = ip % (4 * nside) + 1;
    kshift = (iring + nside) & 1;
    nr = nside;
    int64_t ire = iring - nside + 1;
    int64_t irm = 2 * nside + 2 - ire;
    int64_t ifm = (iphi - ire / 2 + nside - 1) / nside;
    int64_t ifp = (iphi - irm / 2 + nside - 1) / nside;
    if (ifp == ifm)
      face = static_cast<int>(ifp | 4);
    else if (ifp < ifm)
      face = static_cast<int>(ifp);
    else
      face = static_cast<int>(ifm + 8);
  } else {  // south polar cap
    int64_t ip = npix - pix;
    iring = (1 + isqrt(2 * ip - 1)) >> 1;
    iphi = 4 * iring + 1 - (ip - 2 * iring * (iring - 1));
    kshift = 0;
    nr = iring;
    iring = 4 * nside - iring;
    face = 8 + static_cast<int>((iphi - 1) / nr);
  }
  int64_t irt = iring - jrll[face] * nside + 1;
  int64_t ipt = 2 * iphi - jpll[face] * nr - kshift - 1;
  if (ipt >= 2 * nside) ipt -= 8 * nside;
  Xyf r;
  r.ix = (ipt - irt) >> 1;
  r.iy = (-ipt - irt) >> 1;
  r.face = face;
  return r;
}

inline int64_t xyf2ring(int64_t nside, const Xyf &x) {
  int64_t nl4 = 4 * nside;
  int64_t jr = jrll[x.face] * nside - x.ix - x.iy - 1;
  int64_t nr, kshift, n_before;
  int64_t npix = 12 * nside * nside;
  int64_t ncap = 2 * nside * (nside - 1);
  if (jr < nside) {  // north cap
    nr = jr;
    n_before = 2 * nr * (nr - 1);
    kshift = 0;
  } else if (jr > 3 * nside) {  // south cap
    nr = nl4 - jr;
    n_before = npix - 2 * (nr + 1) * nr;
    kshift = 0;
  } else {
    nr = nside;
    n_before = ncap + (jr - nside) * nl4;
    kshift = (jr - nside) & 1;
  }
  int64_t jp = (jpll[x.face] * nr + x.ix - x.iy + 1 + kshift) / 2;
  if (jp > nl4)
    jp -= nl4;
  else if (jp < 1)
    jp += nl4;
  return n_before + jp - 1;
}

}  // namespace

extern "C" {

void hpx_pix2ang_ring(int64_t nside, const int64_t *pix, int64_t n,
                      double *theta, double *phi) {
  for (int64_t i = 0; i < n; ++i)
    pix2ang_ring_one(nside, pix[i], theta + i, phi + i);
}

void hpx_ang2pix_ring(int64_t nside, const double *theta, const double *phi,
                      int64_t n, int64_t *pix) {
  for (int64_t i = 0; i < n; ++i)
    pix[i] = ang2pix_ring_one(nside, theta[i], phi[i]);
}

void hpx_nest2ring(int64_t nside, const int64_t *pin, int64_t n,
                   int64_t *pout) {
  for (int64_t i = 0; i < n; ++i)
    pout[i] = xyf2ring(nside, nest2xyf(nside, pin[i]));
}

void hpx_ring2nest(int64_t nside, const int64_t *pin, int64_t n,
                   int64_t *pout) {
  for (int64_t i = 0; i < n; ++i)
    pout[i] = xyf2nest(nside, ring2xyf(nside, pin[i]));
}

void hpx_pix2ang_nest(int64_t nside, const int64_t *pix, int64_t n,
                      double *theta, double *phi) {
  for (int64_t i = 0; i < n; ++i) {
    Xyf x = nest2xyf(nside, pix[i]);
    double z, ph;
    xyf2loc((x.ix + 0.5) / nside, (x.iy + 0.5) / nside, x.face, &z, &ph);
    theta[i] = std::acos(std::max(-1.0, std::min(1.0, z)));
    phi[i] = ph;
  }
}

void hpx_ang2pix_nest(int64_t nside, const double *theta, const double *phi,
                      int64_t n, int64_t *pix) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t pr = ang2pix_ring_one(nside, theta[i], phi[i]);
    pix[i] = xyf2nest(nside, ring2xyf(nside, pr));
  }
}

// 8 neighbors (nested scheme, healpy order SW, W, NW, N, NE, E, SE, S);
// missing corner neighbors are -1.  Geometric construction, exact by
// design:
//  - edge neighbors: probe a point a tiny epsilon beyond the midpoint of
//    the shared edge (the face chart is exact on and near the boundary);
//  - corner neighbors: sample a tiny circle around the shared corner
//    point on the sphere; the pixels meeting at the corner are recovered
//    exactly, and the diagonal neighbor is the one that is neither the
//    pixel itself nor one of its edge neighbors (absent for the classic
//    7-neighbor corner pixels -> -1, healpy convention).
void hpx_neighbors_nest(int64_t nside, const int64_t *pix, int64_t n,
                        int64_t *out) {
  // healpy order: SW, W, NW, N, NE, E, SE, S in within-face (x, y)
  // offsets (x increases towards NE, y towards NW).
  const int dx[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
  const int dy[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
  const double eps = 1e-7;
  for (int64_t i = 0; i < n; ++i) {
    Xyf x = nest2xyf(nside, pix[i]);
    int64_t nbs[8];
    // --- pass 1: edge neighbors (d odd in this ordering) ---------------
    for (int d = 1; d < 8; d += 2) {
      int64_t ix2 = x.ix + dx[d], iy2 = x.iy + dy[d];
      if (ix2 >= 0 && ix2 < nside && iy2 >= 0 && iy2 < nside) {
        nbs[d] = xyf2nest(nside, Xyf{ix2, iy2, x.face});
        continue;
      }
      double fx = (x.ix + 0.5 + (0.5 + eps) * dx[d]) / nside;
      double fy = (x.iy + 0.5 + (0.5 + eps) * dy[d]) / nside;
      double z, ph;
      xyf2loc(fx, fy, x.face, &z, &ph);
      double th = std::acos(std::max(-1.0, std::min(1.0, z)));
      int64_t pr = ang2pix_ring_one(nside, th, ph);
      nbs[d] = xyf2nest(nside, ring2xyf(nside, pr));
    }
    // --- pass 2: corner neighbors (d even) -----------------------------
    for (int d = 0; d < 8; d += 2) {
      int64_t ix2 = x.ix + dx[d], iy2 = x.iy + dy[d];
      if (ix2 >= 0 && ix2 < nside && iy2 >= 0 && iy2 < nside) {
        nbs[d] = xyf2nest(nside, Xyf{ix2, iy2, x.face});
        continue;
      }
      // Corner point in face coordinates (exactly on the boundary).
      double fx = (x.ix + (dx[d] > 0 ? 1.0 : 0.0)) / nside;
      double fy = (x.iy + (dy[d] > 0 ? 1.0 : 0.0)) / nside;
      double z, ph;
      xyf2loc(fx, fy, x.face, &z, &ph);
      double th = std::acos(std::max(-1.0, std::min(1.0, z)));
      double r = 1e-5 * (PI / (2.0 * nside));
      int64_t cand = -1;
      int n_cand = 0;
      bool at_pole = !(th > r && th < PI - r);
      for (int k = 0; k < 16; ++k) {
        double alpha = (2 * PI * k) / 16.0 + 0.05;
        double th2, ph2;
        if (at_pole) {
          // corner is a pole: the circle around the pole visits all four
          // polar faces; the diagonal neighbor is the non-edge one.
          th2 = (th <= r) ? r : PI - r;
          ph2 = alpha;
        } else {
          th2 = th + r * std::cos(alpha);
          ph2 = ph + r * std::sin(alpha) / std::sin(th);
        }
        int64_t pr = ang2pix_ring_one(nside, th2, ph2);
        int64_t q = xyf2nest(nside, ring2xyf(nside, pr));
        if (q == pix[i]) continue;
        bool is_edge = false;
        for (int e = 1; e < 8; e += 2)
          if (nbs[e] == q) is_edge = true;
        if (is_edge || q == cand) continue;
        if (n_cand > 0 && q != cand) {
          // more than one distinct candidate: keep the first (can only
          // happen at a pole where two opposite-face pixels are seen;
          // both are corner-adjacent, pick deterministically)
          continue;
        }
        cand = q;
        ++n_cand;
      }
      nbs[d] = (n_cand >= 1) ? cand : -1;
    }
    for (int d = 0; d < 8; ++d) out[8 * i + d] = nbs[d];
  }
}

void hpx_pix2vec_ring(int64_t nside, const int64_t *pix, int64_t n,
                      double *xyz) {
  for (int64_t i = 0; i < n; ++i) {
    double th, ph;
    pix2ang_ring_one(nside, pix[i], &th, &ph);
    xyz[3 * i] = std::sin(th) * std::cos(ph);
    xyz[3 * i + 1] = std::sin(th) * std::sin(ph);
    xyz[3 * i + 2] = std::cos(th);
  }
}

int64_t hpx_npix(int64_t nside) { return 12 * nside * nside; }
}
