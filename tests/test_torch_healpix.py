"""Parity of the port's HEALPix pixelization (``nifty_tpu_torch.ops.healpix``,
its own copy of the C++ core, built with the host's compiler) with
``nifty_tpu.ops.healpix`` at nside 1, 2, 4 and 16: every function, both
schemes.  The two libraries compile the same source, so the results are
equal (tolerance 0).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from nifty_tpu.ops import healpix as jh  # noqa: E402
from nifty_tpu_torch.ops import healpix as th  # noqa: E402

NSIDES = [1, 2, 4, 16]


@pytest.mark.parametrize("nside", NSIDES)
@pytest.mark.parametrize("nest", [False, True], ids=["ring", "nest"])
def test_pixel_functions_match(nside, nest):
    assert th.npix(nside) == jh.npix(nside) == 12 * nside ** 2
    pix = np.arange(th.npix(nside))
    for a, b in zip(th.pix2ang(nside, pix, nest=nest), jh.pix2ang(nside, pix, nest=nest)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(th.pix2vec(nside, pix, nest=nest),
                                  jh.pix2vec(nside, pix, nest=nest))
    rng = np.random.default_rng(nside)
    theta = np.arccos(rng.uniform(-1.0, 1.0, 500))
    phi = rng.uniform(0.0, 2 * np.pi, 500)
    np.testing.assert_array_equal(th.ang2pix(nside, theta, phi, nest=nest),
                                  jh.ang2pix(nside, theta, phi, nest=nest))
    # pixel centres map back to their pixels
    np.testing.assert_array_equal(th.ang2pix(nside, *th.pix2ang(nside, pix, nest=nest), nest=nest),
                                  pix)


@pytest.mark.parametrize("nside", NSIDES)
def test_scheme_conversions_and_neighbours_match(nside):
    pix = np.arange(th.npix(nside))
    ring = th.nest2ring(nside, pix)
    np.testing.assert_array_equal(ring, jh.nest2ring(nside, pix))
    np.testing.assert_array_equal(th.ring2nest(nside, pix), jh.ring2nest(nside, pix))
    np.testing.assert_array_equal(th.ring2nest(nside, ring), pix)
    nb = th.neighbours_nest(nside, pix)
    np.testing.assert_array_equal(nb, jh.neighbours_nest(nside, pix))
    assert nb.shape == (pix.size, 8)
    # the 7-neighbour pixels miss a corner (-1), which the refinement
    # windows replace by the centre
    assert int((nb < 0).sum()) > 0
    # scalars in, arrays of one out
    np.testing.assert_array_equal(th.neighbours_nest(nside, 0), jh.neighbours_nest(nside, 0))
    np.testing.assert_array_equal(th.pix2vec(nside, 0), jh.pix2vec(nside, 0))
