"""Chain wrappers around HMC/NUTS (counterpart of :mod:`nifty_tpu.hmc_oo`).

``generate_n_samples`` runs the transitions as a Python loop and stacks
the samples and per-transition diagnostics.  The potential's gradient is
``torch.autograd.grad`` of the potential; its value and gradient at a
position are computed together and kept for that position, so a leapfrog
step, which ends where the next one starts, evaluates the potential once.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, TypeVar, Union

import torch

from .hmc import (
    QP,
    _kinetic_energy,
    _kinetic_energy_gradient,
    generate_hmc_acc_rej,
    generate_nuts_tree,
    leapfrog_step,
    sample_momentum_from_diagonal,
)
from .tree import stack, tree_leaves, tree_map, tree_unflatten

Q = TypeVar("Q")


def _parse_diag_mass_matrix(mass_matrix, position_proto):
    if isinstance(mass_matrix, (int, float)) or (
            torch.is_tensor(mass_matrix) and mass_matrix.numel() == 1):
        return tree_map(lambda p: torch.full_like(p, float(mass_matrix)), position_proto)
    try:
        same_shape = tree_leaves(tree_map(lambda m, p: tuple(m.shape) == tuple(p.shape),
                                          mass_matrix, position_proto))
    except (KeyError, IndexError, TypeError, AttributeError):
        same_shape = None
    if same_shape is None or len(same_shape) != len(tree_leaves(mass_matrix)):
        raise TypeError("mass matrix must be scalar or match the position structure")
    if not all(same_shape):
        raise ValueError("mass matrix shapes do not match position")
    return mass_matrix


class _Potential:
    """The potential energy and its gradient (``torch.autograd.grad``),
    computed together and kept for the last position asked about (by
    identity: positions are never changed in place here)."""

    def __init__(self, potential_energy: Callable):
        self.potential_energy = potential_energy
        self._at = None

    def _eval(self, q):
        if self._at is not q:
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(True) for x in tree_leaves(q)]
                value = self.potential_energy(tree_unflatten(q, leaves))
                grads = torch.autograd.grad(value, leaves)
            self._at, self._value, self._grad = q, value.detach(), tree_unflatten(q, grads)

    def value(self, q):
        self._eval(q)
        return self._value

    def grad(self, q):
        self._eval(q)
        return self._grad


class Chain(NamedTuple):
    """Chain output: stacked samples + per-step diagnostics."""

    samples: Q
    divergences: torch.Tensor
    acceptance: Union[torch.Tensor, float]
    depths: Optional[torch.Tensor] = None
    resampled_momenta: Optional[Q] = None


class _Sampler:
    def __init__(
        self,
        potential_energy: Callable,
        inverse_mass_matrix,
        position_proto,
        step_size: float = 1.0,
        max_energy_difference: float = math.inf,
    ):
        if not callable(potential_energy):
            raise TypeError("`potential_energy` must be callable")
        self.potential_energy = potential_energy
        self.inverse_mass_matrix = _parse_diag_mass_matrix(inverse_mass_matrix, position_proto)
        self.mass_matrix_sqrt = tree_map(lambda x: x ** -0.5, self.inverse_mass_matrix)
        self.step_size = step_size
        self.max_energy_difference = max_energy_difference
        self.kinetic_energy = lambda p: _kinetic_energy(self.inverse_mass_matrix, p)
        self._potential = _Potential(potential_energy)

    def sample_next_state(self, key, position):
        raise NotImplementedError()

    def generate_n_samples(self, key, initial_position, num_samples: int
                           ) -> Tuple[Chain, Tuple[Any, Q]]:
        """Run ``num_samples`` transitions from ``initial_position``;
        ``key`` is an int seed (a host ``torch.Generator`` seeded with it)
        or a ``torch.Generator``, drawn from in place.  Returns the chain
        and ``(key, last position)``."""
        if not isinstance(key, torch.Generator):
            key = torch.Generator().manual_seed(int(key))
        pos, outs = initial_position, []
        for _ in range(num_samples):
            out, pos = self.sample_next_state(key, pos)
            outs.append(out)
        return self._to_chain(outs), (key, pos)

    def _to_chain(self, outs) -> Chain:
        raise NotImplementedError()


def _float_dtype(position):
    """The dtype of ``position``'s first floating leaf (float64 without
    one): a chain's statistics take its precision."""
    for x in tree_leaves(position):
        if x.is_floating_point():
            return x.dtype
    return torch.float64


class NUTSChain(_Sampler):
    """No-U-turn chain; see :func:`nifty_tpu_torch.hmc.generate_nuts_tree`."""

    def __init__(self, potential_energy, inverse_mass_matrix, position_proto, step_size=1.0,
                 max_tree_depth: int = 10, bias_transition: bool = True,
                 max_energy_difference: float = 1000.0):
        super().__init__(potential_energy, inverse_mass_matrix, position_proto,
                         step_size=step_size, max_energy_difference=max_energy_difference)
        self.max_tree_depth = max_tree_depth
        self.bias_transition = bias_transition

    def sample_next_state(self, key, position):
        momentum = sample_momentum_from_diagonal(key=key, mass_matrix_sqrt=self.mass_matrix_sqrt)
        qp = QP(position=position, momentum=momentum)

        def stepper(qp_, eps, go_right):
            return leapfrog_step(self._potential.grad, _kinetic_energy_gradient,
                                 eps if go_right else -eps, self.inverse_mass_matrix, qp_)

        tree = generate_nuts_tree(
            qp, key, self.step_size, self.max_tree_depth, stepper, self._potential.value,
            self.kinetic_energy, bias_transition=self.bias_transition,
            max_energy_difference=self.max_energy_difference)
        new_pos = tree.proposal_candidate.position
        return (new_pos, tree.diverging, tree.cumulative_acceptance, tree.depth), new_pos

    def _to_chain(self, outs) -> Chain:
        samples, div, acc, depths = zip(*outs)
        depths = torch.tensor(depths, dtype=torch.int64)
        # Normalize the tree's summed Metropolis statistic by its number of
        # proposals (2^depth - 1) so ``acceptance`` is a per-transition
        # probability in [0, 1] (reference: ``src/re/hmc_oo.py:237-240``),
        # in float (the position's): an integer 2**depth overflows for large
        # depths.
        dtype = _float_dtype(samples[0])
        num_prop = 2.0 ** depths.to(dtype) - 1.0
        acc = torch.tensor(acc, dtype=dtype)
        acc = torch.where(num_prop > 0, acc / num_prop.clamp_min(1.0), 0.0)
        return Chain(samples=stack(list(samples)), divergences=torch.tensor(div),
                     acceptance=acc, depths=depths)


class HMCChain(_Sampler):
    """Fixed-trajectory-length Metropolis HMC chain."""

    def __init__(self, potential_energy, inverse_mass_matrix, position_proto,
                 num_steps: int = 10, step_size=1.0,
                 max_energy_difference: float = math.inf):
        super().__init__(potential_energy, inverse_mass_matrix, position_proto,
                         step_size=step_size, max_energy_difference=max_energy_difference)
        self.num_steps = num_steps

    def sample_next_state(self, key, position):
        momentum = sample_momentum_from_diagonal(key=key, mass_matrix_sqrt=self.mass_matrix_sqrt)
        qp = QP(position=position, momentum=momentum)
        acc_rej = generate_hmc_acc_rej(
            key=key, initial_qp=qp, potential_energy=self._potential.value,
            potential_energy_gradient=self._potential.grad,
            inverse_mass_matrix=self.inverse_mass_matrix, step_size=self.step_size,
            num_steps=self.num_steps, max_energy_difference=self.max_energy_difference)
        new_pos = acc_rej.accepted_qp.position
        return (new_pos, acc_rej.diverging, acc_rej.accepted), new_pos

    def _to_chain(self, outs) -> Chain:
        samples, div, acc = zip(*outs)
        return Chain(samples=stack(list(samples)), divergences=torch.tensor(div),
                     acceptance=torch.tensor(acc))
