"""HEALPix pixelization, ring and nested (counterpart of
:mod:`nifty_tpu.ops.healpix`).

Pixel <-> angle maps, scheme conversions, pixel-centre vectors and the
8-neighbour tables of the nested scheme, computed on the host by the C++
core ``csrc/healpix.cpp`` (a copy of the JAX package's), which
:func:`~nifty_tpu_torch.ops.cuda_build.load_host_library` compiles with the
host's C++ compiler at first use and loads with ``ctypes``.  Everything
here is host precompute on numpy arrays: the refinement charts turn it
into index tables and matrices.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .cuda_build import load_host_library

_SIGNATURES_SET = []


def _lib():
    lib = load_host_library("healpix")
    if not _SIGNATURES_SET:
        i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        dp = ctypes.POINTER(ctypes.c_double)
        for name, args in (
            ("hpx_pix2ang_ring", [i64, i64p, i64, dp, dp]),
            ("hpx_ang2pix_ring", [i64, dp, dp, i64, i64p]),
            ("hpx_pix2ang_nest", [i64, i64p, i64, dp, dp]),
            ("hpx_ang2pix_nest", [i64, dp, dp, i64, i64p]),
            ("hpx_nest2ring", [i64, i64p, i64, i64p]),
            ("hpx_ring2nest", [i64, i64p, i64, i64p]),
            ("hpx_neighbors_nest", [i64, i64p, i64, i64p]),
            ("hpx_pix2vec_ring", [i64, i64p, i64, dp]),
        ):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = None
        _SIGNATURES_SET.append(True)
    return lib


def _as_i64(x):
    return np.ascontiguousarray(np.atleast_1d(x), dtype=np.int64)


def _as_f64(x):
    return np.ascontiguousarray(np.atleast_1d(x), dtype=np.float64)


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def npix(nside: int) -> int:
    return 12 * int(nside) ** 2


def pix2ang(nside: int, pix, nest: bool = False):
    pix = _as_i64(pix)
    theta = np.empty(pix.size)
    phi = np.empty(pix.size)
    fn = _lib().hpx_pix2ang_nest if nest else _lib().hpx_pix2ang_ring
    fn(nside, _i64p(pix), pix.size, _f64p(theta), _f64p(phi))
    return theta, phi


def ang2pix(nside: int, theta, phi, nest: bool = False):
    theta, phi = _as_f64(theta), _as_f64(phi)
    out = np.empty(theta.size, dtype=np.int64)
    fn = _lib().hpx_ang2pix_nest if nest else _lib().hpx_ang2pix_ring
    fn(nside, _f64p(theta), _f64p(phi), theta.size, _i64p(out))
    return out


def nest2ring(nside: int, pix):
    pix = _as_i64(pix)
    out = np.empty(pix.size, dtype=np.int64)
    _lib().hpx_nest2ring(nside, _i64p(pix), pix.size, _i64p(out))
    return out


def ring2nest(nside: int, pix):
    pix = _as_i64(pix)
    out = np.empty(pix.size, dtype=np.int64)
    _lib().hpx_ring2nest(nside, _i64p(pix), pix.size, _i64p(out))
    return out


def neighbours_nest(nside: int, pix):
    """8 neighbours per pixel (SW, W, NW, N, NE, E, SE, S); -1 = missing."""
    pix = _as_i64(pix)
    out = np.empty(8 * pix.size, dtype=np.int64)
    _lib().hpx_neighbors_nest(nside, _i64p(pix), pix.size, _i64p(out))
    return out.reshape(pix.size, 8)


def pix2vec(nside: int, pix, nest: bool = False):
    """Unit vectors of the pixel centres, shape (n, 3)."""
    pix = _as_i64(pix)
    if nest:
        pix = nest2ring(nside, pix)
    out = np.empty(3 * pix.size)
    _lib().hpx_pix2vec_ring(nside, _i64p(pix), pix.size, _f64p(out))
    return out.reshape(pix.size, 3)
