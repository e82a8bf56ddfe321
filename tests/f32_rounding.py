"""How far float32 rounding may move a plain statevector run of the port
from the same run in complex128: the tolerances of the pass-order tests.

u = 2^-24 is float32's unit roundoff. A float32 sum of m terms whose sizes
add up to S is off by at most LAMBDA * sqrt(m) * u * S, except with a
probability under 2m exp(-LAMBDA^2 / 2): the probabilistic bound of Higham
and Mary (SIAM J. Sci. Comput. 41 (2019) A2815); LAMBDA = 6 keeps that
under 1e-3 for the longest sums here (2^16 amplitudes).

A step is the kick, then the step's diagonal e^{i theta(s)}:
- theta(s) = c0 + sum_k c_k z_k(s) is a float32 sum of 2L terms whose sizes
  add up to Theta = sum |c| of the step's folded row, so each phase, and
  each amplitude with it, moves by at most LAMBDA sqrt(2L) u Theta;
- the kick applies unitary factors of at most 7 qubits (the plain
  versions' kron groups; the replays' one-qubit factors round less), each
  output amplitude a float32 sum of 2^(7+2) real products, so a step's
  ceil(L/7) factors move the unit state by at most
  ceil(L/7) LAMBDA sqrt(2^9) u.
The steps are unitary, so they carry earlier errors unchanged: after the
steps the state is off by the sum of theirs. An expectation of an operator
of norm |O| then moves by at most 2 |O| times that, and its float32 sum
over the 2^L amplitudes adds LAMBDA sqrt(2^L) u |O|.
"""

import math

U = 2.0 ** -24
LAMBDA = 6.0


def state_error(thetas, L: int) -> float:
    """Bound on the unit state's float32 error after steps whose folded
    rows have sum |c| = ``thetas`` (one a step)."""
    kick = math.ceil(L / 7) * math.sqrt(2 ** 9)
    return sum(LAMBDA * U * (math.sqrt(2 * L) * th + kick) for th in thetas)


def expectation_error(thetas, L: int, norm: float = 1.0) -> float:
    """Bound on the float32 error of an expectation of an operator of norm
    ``norm`` measured after those steps."""
    return norm * (2 * state_error(thetas, L)
                   + LAMBDA * U * math.sqrt(2 ** L))


def sum_order_gap(L: int, norm: float = 1.0) -> float:
    """Bound on the gap between two float32 sums of the same 2^L terms in
    different orders, the terms' sizes adding up to ``norm``."""
    return 2 * LAMBDA * U * math.sqrt(2 ** L) * norm
