"""Hamiltonian Monte Carlo and iterative NUTS (counterpart of
:mod:`nifty_tpu.hmc`).

The inference cross-check on the *same* standardized log-density the VI
engine optimizes.  Algorithms from the standard literature (Neal 2011;
Betancourt 2017; Phan et al. iterative NUTS): leapfrog integration with a
diagonal mass matrix, Metropolis-corrected fixed-length HMC, and no-U-turn
sampling by iterative tree doubling with progressive (multinomial within a
subtree, biased across subtrees) proposal sampling and the trailing-bits
checkpoint U-turn scheme of the iterative formulation.

The JAX package compiles whole trajectories into ``lax`` loops; here they
are Python loops over tensor trees, and the decisions a trajectory makes
(accept, take a proposal, stop at a U-turn or a divergence) are taken on
the host: each leapfrog leaf reads its energy and U-turn checks back once.
Random numbers come from an explicit ``torch.Generator`` (the ``key``),
drawn from in place: momenta as :func:`~nifty_tpu_torch.tree.random_like`
draws them, uniforms with ``torch.rand``.  A trajectory's decisions are
Python ``bool`` / ``float`` / ``int`` values; positions and momenta stay
tensors on their device.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, TypeVar

import numpy as np
import torch

from .tree import random_like, tree_leaves, tree_map, vdot

Q = TypeVar("Q")


def _uniform(key) -> float:
    """A uniform draw in [0, 1) from the generator ``key``; a number given
    as ``key`` is taken as the draw itself (so that a caller can replay
    another stream's uniforms)."""
    if isinstance(key, torch.Generator):
        return float(torch.rand((), generator=key, dtype=torch.float64, device=key.device))
    return float(key)


class QP(NamedTuple):
    """Position/momentum phase-space point."""

    position: Q
    momentum: Q


def flip_momentum(qp: QP) -> QP:
    return QP(position=qp.position, momentum=tree_map(torch.neg, qp.momentum))


def sample_momentum_from_diagonal(*, key, mass_matrix_sqrt):
    """Momentum ~ N(0, M) for diagonal M given via its square root."""
    normal = random_like(key, mass_matrix_sqrt)
    return tree_map(torch.mul, mass_matrix_sqrt, normal)


def _kinetic_energy(inverse_mass_matrix, momentum):
    se = tree_map(lambda im, p: torch.sum(im * p ** 2), inverse_mass_matrix, momentum)
    total = 0.0
    for leaf in tree_leaves(se):
        total = total + leaf
    return 0.5 * total


def _kinetic_energy_gradient(inverse_mass_matrix, momentum):
    return tree_map(torch.mul, inverse_mass_matrix, momentum)


def leapfrog_step(
    potential_energy_gradient: Callable,
    kinetic_energy_gradient: Callable,
    step_size,
    inverse_mass_matrix,
    qp: QP,
) -> QP:
    """One leapfrog (velocity-Verlet) step forward in time."""
    p_half = tree_map(lambda p, g: p - (step_size / 2.0) * g, qp.momentum,
                      potential_energy_gradient(qp.position))
    q_full = tree_map(lambda q, v: q + step_size * v, qp.position,
                      kinetic_energy_gradient(inverse_mass_matrix, p_half))
    p_full = tree_map(lambda p, g: p - (step_size / 2.0) * g, p_half,
                      potential_energy_gradient(q_full))
    return QP(position=q_full, momentum=p_full)


def total_energy_of_qp(qp, potential_energy, kinetic_energy_w_inv_mass):
    return potential_energy(qp.position) + kinetic_energy_w_inv_mass(qp.momentum)


# --------------------------------------------------------------------------
# Fixed-length HMC with accept/reject
# --------------------------------------------------------------------------


class AcceptedAndRejected(NamedTuple):
    accepted_qp: QP
    rejected_qp: QP
    accepted: bool
    diverging: bool


def generate_hmc_acc_rej(
    *,
    key,
    initial_qp: QP,
    potential_energy: Callable,
    potential_energy_gradient: Callable,
    kinetic_energy: Callable = None,
    inverse_mass_matrix,
    step_size,
    num_steps: int,
    max_energy_difference: float = math.inf,
) -> AcceptedAndRejected:
    """Integrate a fixed-length trajectory and Metropolis-accept it."""
    ke = partial(_kinetic_energy if kinetic_energy is None else kinetic_energy,
                 inverse_mass_matrix)
    step = partial(leapfrog_step, potential_energy_gradient, _kinetic_energy_gradient,
                   step_size, inverse_mass_matrix)
    proposed = initial_qp
    for _ in range(num_steps):
        proposed = step(proposed)
    # Flip momentum for a symmetric proposal (detailed balance).
    proposed = flip_momentum(proposed)

    e0 = total_energy_of_qp(initial_qp, potential_energy, ke)
    e1 = total_energy_of_qp(proposed, potential_energy, ke)
    energy_diff = float(e0 - e1)
    diverging = abs(energy_diff) > max_energy_difference
    accept = _uniform(key) < math.exp(min(energy_diff, 0.0)) and not math.isnan(energy_diff)
    accepted_qp, rejected_qp = (proposed, initial_qp) if accept else (initial_qp, proposed)
    return AcceptedAndRejected(accepted_qp=accepted_qp, rejected_qp=rejected_qp,
                               accepted=accept, diverging=diverging)


# --------------------------------------------------------------------------
# Iterative NUTS
# --------------------------------------------------------------------------


class Tree(NamedTuple):
    """A trajectory tree: endpoints, a sampled proposal, and its stats."""

    left: QP
    right: QP
    logweight: float
    proposal_candidate: QP
    turning: bool
    diverging: bool
    depth: int
    cumulative_acceptance: float


def _ckpt_idx_range(n: int):
    """Checkpoint index range for 0-based leaf index ``n``.

    ``idx_max`` = popcount(n >> 1); ``num_subtrees`` = number of trailing
    set bits of ``n``; ``idx_min = idx_max - num_subtrees + 1``.  For even
    ``n`` the new state is stored at ``idx_max``; for odd ``n`` the U-turn
    check runs against checkpoints ``idx_min..idx_max`` (iterative NUTS).
    """
    n = int(n)
    idx_max = bin(n >> 1).count("1")
    num_subtrees = 0
    while (n >> num_subtrees) & 1:
        num_subtrees += 1
    return idx_max - num_subtrees + 1, idx_max


def is_euclidean_uturn(qp_left: QP, qp_right: QP):
    """U-turn: the two trajectory ends move toward each other (a 0-d bool
    tensor).

    Both momenta are forward-time; turning iff the right end's momentum
    projects negatively on (q_r - q_l) AND the left end's projects
    negatively on (q_l - q_r).
    """
    dq = tree_map(torch.sub, qp_right.position, qp_left.position)
    return ((vdot(qp_right.momentum, dq).real < 0.0)
            & (vdot(qp_left.momentum, tree_map(torch.neg, dq)).real < 0.0))


def _logaddexp(a: float, b: float) -> float:
    return float(np.logaddexp(a, b))


def iterative_build_tree(
    key,
    initial_qp: QP,
    eps,
    go_right: bool,
    depth: int,
    stepper: Callable,
    potential_energy: Callable,
    kinetic_energy: Callable,
    maxdepth: int,
    max_energy_difference,
) -> Tree:
    """Build a subtree of 2^depth new states in direction ``go_right``.

    Keeps ``maxdepth + 1`` checkpoint states; per new leaf the U-turn
    check runs against the checkpoints selected by :func:`_ckpt_idx_range`
    — the iterative formulation of recursive NUTS sub-U-turn checking.
    Each leaf reads its energy and its U-turn checks back to the host once.
    """
    e0 = float(total_energy_of_qp(initial_qp, potential_energy, kinetic_energy))
    chk = [None] * (maxdepth + 1)
    tree = Tree(left=initial_qp, right=initial_qp, logweight=-math.inf,
                proposal_candidate=initial_qp, turning=False, diverging=False, depth=-1,
                cumulative_acceptance=0.0)
    z = initial_qp
    n = 0
    while n < (1 << depth) and not tree.turning and not tree.diverging:
        z = stepper(z, eps, go_right)
        e_z = total_energy_of_qp(z, potential_energy, kinetic_energy)
        idx_min, idx_max = _ckpt_idx_range(n)
        # Even leaf: store checkpoint.  Odd leaf: U-turn check against
        # checkpoints idx_min..idx_max.
        checks = []
        if n & 1 == 0:
            chk[idx_max] = z
        else:
            checks = [is_euclidean_uturn(chk[i], z) for i in range(idx_min, idx_max + 1)]
        # one host read of the energy and the checks, in the energy's dtype
        e_z = e_z if torch.is_tensor(e_z) else torch.as_tensor(e_z, dtype=torch.float64)
        read = torch.stack([e_z] + [c.to(e_z.dtype) for c in checks]).tolist()
        energy_diff = e0 - read[0]
        energy_diff = -math.inf if math.isnan(energy_diff) else energy_diff
        diverging = abs(energy_diff) > max_energy_difference
        turning = any(v != 0.0 for v in read[1:])

        # Progressive multinomial proposal within the subtree.
        new_logweight = _logaddexp(tree.logweight, energy_diff)
        take_new = _uniform(key) < math.exp(energy_diff - new_logweight)
        acc = min(1.0, math.exp(min(energy_diff, 0.0)))
        tree = Tree(
            left=z if n == 0 else tree.left,
            right=z,
            logweight=new_logweight,
            proposal_candidate=z if take_new else tree.proposal_candidate,
            turning=tree.turning or turning,
            diverging=tree.diverging or diverging,
            depth=tree.depth,
            cumulative_acceptance=tree.cumulative_acceptance + acc,
        )
        n += 1
    return tree


def generate_nuts_tree(
    initial_qp: QP,
    key,
    eps,
    maxdepth: int,
    stepper: Callable,
    potential_energy: Callable,
    kinetic_energy: Callable,
    bias_transition: bool = True,
    max_energy_difference: float = 1000.0,
) -> Tree:
    """No-U-turn trajectory: double until U-turn/divergence/maxdepth.

    Returns the final :class:`Tree` whose ``proposal_candidate`` is the
    next chain state.
    """
    tree = Tree(left=initial_qp, right=initial_qp, logweight=0.0,
                proposal_candidate=initial_qp, turning=False, diverging=False, depth=0,
                cumulative_acceptance=0.0)
    while tree.depth <= maxdepth and not tree.turning and not tree.diverging:
        go_right = _uniform(key) < 0.5
        start = tree.right if go_right else tree.left
        new_subtree = iterative_build_tree(
            key, start, eps, go_right, tree.depth, stepper, potential_energy,
            kinetic_energy, maxdepth, max_energy_difference)
        tree = _merge_trees(key, tree, new_subtree, go_right, bias_transition)
        tree = tree._replace(depth=tree.depth + 1)
    return tree


def _merge_trees(key, current: Tree, new_subtree: Tree, go_right: bool,
                 bias_transition: bool) -> Tree:
    """Merge the freshly built subtree into the trajectory.

    Across subtrees the transition is *biased* toward the new subtree
    (prob min(1, w_new/w_cur)) when ``bias_transition``, otherwise plain
    multinomial.  ``key``: the generator of the transition's uniform, or
    the uniform itself.
    """
    subtree_bad = new_subtree.turning or new_subtree.diverging
    lw_new = -math.inf if subtree_bad else new_subtree.logweight
    if bias_transition:
        p_new = min(1.0, math.exp(min(lw_new - current.logweight, 0.0)))
    else:
        p_new = math.exp(lw_new - _logaddexp(current.logweight, lw_new))
    take_new = _uniform(key) < p_new
    proposal = new_subtree.proposal_candidate if take_new else current.proposal_candidate
    left = current.left if go_right else new_subtree.right
    right = new_subtree.right if go_right else current.right
    # Outermost U-turn check across the merged trajectory; a bad subtree
    # terminates the doubling but keeps the current proposal.
    turning = new_subtree.turning or bool(is_euclidean_uturn(left, right))
    return Tree(
        left=left,
        right=right,
        logweight=_logaddexp(current.logweight, lw_new),
        proposal_candidate=proposal,
        turning=turning,
        diverging=new_subtree.diverging,
        depth=current.depth,
        cumulative_acceptance=current.cumulative_acceptance
        + new_subtree.cumulative_acceptance,
    )
