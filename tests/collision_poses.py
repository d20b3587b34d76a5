"""Seeded narrowphase inputs and the set comparison of the PyTorch port's
collision tests (``tests/test_torch_collision_*.py``).

A case is ``(p1, m1, s1, p2, m2, s2, margin)`` over N pairs, float64
numpy.  Poses mix penetrating, touching and separated pairs; a quarter of
the rotations are signed permutations (parallel faces and edges), an
eighth of the directions lie on an axis.  A quarter of the margins are
0.01.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from scipy.spatial.transform import Rotation

N = 256
ACTIVE = 1e9      # dist below this marks a filled slot (empty ones: 1e10)
# moves of geom 2 that show whether the reference is at a tie of its case
# selection (a face, an edge pair, a vertex or a candidate order)
NUDGE = 1e-9


def rotations(rng, n):
  r = Rotation.random(n, random_state=rng).as_matrix()
  for i in range(n // 4):
    p = np.eye(3)[rng.permutation(3)] * rng.choice([-1.0, 1.0], 3)
    if np.linalg.det(p) < 0:
      p[0] *= -1
    r[i] = p
  return r


def directions(rng, n):
  v = rng.standard_normal((n, 3))
  v /= np.linalg.norm(v, axis=1, keepdims=True)
  k = n // 8
  v[:k] = np.eye(3)[rng.integers(0, 3, k)] * rng.choice([-1.0, 1.0], (k, 1))
  return v


def sizes(rng, kind, n):
  """Geom sizes as MjModel.geom_size holds them."""
  if kind == "box":
    return rng.uniform(0.05, 0.15, (n, 3))
  zero = np.zeros(n)
  if kind == "sphere":
    return np.c_[rng.uniform(0.03, 0.1, n), zero, zero]
  if kind == "capsule":
    return np.c_[rng.uniform(0.02, 0.06, n), rng.uniform(0.03, 0.12, n), zero]
  if kind == "cylinder":
    return np.c_[rng.uniform(0.03, 0.1, n), rng.uniform(0.02, 0.1, n), zero]
  return np.zeros((n, 3))    # plane, mesh: the narrowphase reads no size


def margins(rng, n):
  return np.where(rng.uniform(size=n) < 0.25, 0.01, 0.0)


def plane_case(seed, kind2, reach):
  """A plane (any pose) and geom 2 at heights from -0.5 to 1.3 ``reach``
  along the plane's normal."""
  rng = np.random.default_rng(seed)
  m1 = rotations(rng, N)
  p1 = 0.1 * rng.standard_normal((N, 3))
  h = rng.uniform(-0.5, 1.3, N) * reach
  side = 0.05 * rng.standard_normal((N, 3))
  side -= m1[:, :, 2] * np.einsum("ni,ni->n", side, m1[:, :, 2])[:, None]
  p2 = p1 + m1[:, :, 2] * h[:, None] + side
  return (p1, m1, np.zeros((N, 3)), p2, rotations(rng, N),
          sizes(rng, kind2, N), margins(rng, N))


def pair_case(seed, kind1, kind2, reach1, reach2):
  """Geom 2 at 0.3 to 1.2 times the sum of the reaches from geom 1."""
  rng = np.random.default_rng(seed)
  m1, m2 = rotations(rng, N), rotations(rng, N)
  p1 = 0.1 * rng.standard_normal((N, 3))
  s1, s2 = sizes(rng, kind1, N), sizes(rng, kind2, N)
  dist = rng.uniform(0.3, 1.2, N) * (reach1 + reach2)
  p2 = p1 + directions(rng, N) * dist[:, None]
  return p1, m1, s1, p2, m2, s2, margins(rng, N)


def run_jax(fn, case, jit=True):
  """The JAX narrowphase of one pair, vmapped over the case; jitted, or op
  by op where ``jit`` is false."""
  run = jax.vmap(fn)
  out = (jax.jit(run) if jit else run)(*(jnp.asarray(x) for x in case))
  return tuple(np.asarray(x) for x in out[:3])


def run_torch(fn, case):
  out = fn(*(torch.as_tensor(x) for x in case))
  return tuple(x.numpy() for x in out[:3])


def contact_set(out, i, margin):
  """Pair i's filled slots as rows (dist, pos, normal): the set of
  contacts, whatever slot each took.  A slot within 1e-12 of the margin is
  left out: whether a candidate exactly at the margin is kept is a matter
  of rounding, and such a contact carries no force."""
  dist, pos, nrm = out
  act = (dist[i] < ACTIVE) & (np.abs(dist[i] - margin[i]) > 1e-12)
  return np.c_[dist[i][act], pos[i][act], nrm[i][act]]


def set_error(a, b) -> float:
  """Largest difference between two contact sets, each row of ``a`` paired
  with the nearest unpaired row of ``b`` (deepest first); inf if their
  sizes differ."""
  if a.shape != b.shape:
    return np.inf
  free, worst = list(range(len(b))), 0.0
  for row in a[np.argsort(a[:, 0], kind="stable")]:
    err = [float(np.abs(row - b[j]).max()) for j in free]
    k = int(np.argmin(err))
    worst = max(worst, err[k])
    free.pop(k)
  return worst


def nudged(fn, case, jit=True):
  """The JAX reference with geom 2 moved by NUDGE: a seeded shift and
  turn, either way."""
  rng = np.random.default_rng(99)
  n, outs = len(case[0]), []
  shift = NUDGE * rng.standard_normal((n, 3))
  turn = NUDGE * rng.standard_normal((n, 3))
  for sign in (1.0, -1.0):
    moved = list(case)
    moved[3] = case[3] + sign * shift
    moved[4] = Rotation.from_rotvec(sign * turn).as_matrix() @ case[4]
    outs.append(run_jax(fn, moved, jit))
  return outs


def compare_with_jax(jax_fn, torch_fn, case, tol=1e-10, jit=True):
  """The port's contacts against the JAX package's, pair by pair, as sets:
  dist, pos and normal within ``tol``.  Where the reference's contact set
  jumps when geom 2 is nudged (its case selection is at a tie: a face, an
  edge pair, a vertex or a candidate order), either side of the tie is its
  answer: the port's set must then be, within 1e-8, the reference's at the
  pose or at one of the nudged poses.  Returns (pairs with a contact,
  pairs at a tie)."""
  ref = run_jax(jax_fn, case, jit)
  got = run_torch(torch_fn, case)
  others = nudged(jax_fn, case, jit)
  ties, bad = 0, []
  for i in range(len(case[0])):
    want, have = contact_set(ref, i, case[6]), contact_set(got, i, case[6])
    err = set_error(want, have)
    sides = [contact_set(o, i, case[6]) for o in others]
    if max(set_error(want, side) for side in sides) > 1e-6:
      ties += 1
      if min(set_error(side, have) for side in sides) <= 1e-8:
        continue
    if err > tol:
      bad.append((i, err))
  assert not bad, f"pairs off the JAX package's contacts: {bad[:8]}"
  return int((ref[0] < ACTIVE).any(1).sum()), ties
