"""Shared scenes, states and comparisons of the flex tests of the PyTorch
port (``tests/test_torch_flex*.py``).

The scenes are the JAX package's flex tests' MJCF, as
``scripts/flex_models.py`` vendors them.  ``both`` runs one state through
the port's ``forward`` (float64, CPU) and the JAX package's (jitted);
``check_contacts`` holds every active slot's geometry, parameters and
weighted bodies to the JAX package's and the two packages' active sets to
each other.
"""

import os
import sys

import jax
import mujoco
import numpy as np

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import flex_models  # noqa: E402

jax.config.update("jax_enable_x64", True)


def model(xml: str):
  return mujoco.MjModel.from_xml_string(xml)


def scene(name: str):
  """The vendored scene ``name``'s MjModel."""
  return mujoco.MjModel.from_xml_path(str(mt.asset_path(f"{name}.xml")))


def dropped(mjm, steps: int):
  """C's MjData after ``steps`` steps from the model's reset state."""
  mjd = mujoco.MjData(mjm)
  for _ in range(steps):
    mujoco.mj_step(mjm, mjd)
  return mjd


def perturbed(mjm, scale: float, seed: int):
  """qpos0 and zero velocity, both with seeded noise of ``scale``."""
  mjd = mujoco.MjData(mjm)
  rng = np.random.RandomState(seed)
  mjd.qpos[:] = mjm.qpos0 + scale * rng.randn(mjm.nq)
  mjd.qvel[:] = scale * rng.randn(mjm.nv)
  return mjd


def both(mjm, mjd):
  """(port model, port Data, JAX Data) after ``forward`` of the state of
  ``mjd`` in each package."""
  m = mt.put_model(mjm, device="cpu")
  d = mt.forward(m, mt.put_data(m, mjd))
  mj = mi.put_model(mjm, dtype=jax.numpy.float64)
  dj = jax.jit(lambda x: mi.forward(mj, x))(mi.put_data(mj, mjd))
  return m, d, dj


def qacc_error(d, ref) -> float:
  """max|qacc - ref| over max(1, max|ref|) of one lane."""
  ref = np.asarray(ref)
  return float(np.abs(d.qacc[0].numpy() - ref).max()
               / max(1.0, np.abs(ref).max()))


def active(dj) -> np.ndarray:
  c = dj.contact
  return np.asarray(c.dist) < np.asarray(c.includemargin)


def _by_bodies(bary_body: np.ndarray, slots: np.ndarray) -> np.ndarray:
  """The slots ordered by their sides' bodies (an element pair's
  identity)."""
  bb = bary_body[slots].reshape(len(slots), -1)
  return slots[np.lexsort(bb.T[::-1])]


def check_contacts(d, dj, tol: float = 1e-9, slots=None,
                   as_set: bool = False) -> int:
  """The port's contact slots against the JAX package's, slot by slot:
  equal active sets, and on each active slot (of ``slots``, all by
  default) dist, pos, frame and the bodies' weights within ``tol``, the
  geoms, bodies, friction, solref and solimp equal.  ``as_set`` pairs the
  active slots by their bodies instead (a budget's lane-selected slots may
  come in another order where candidates tie).  Returns the active
  count."""
  c, cj = d.contact, dj.contact
  act = active(dj)
  mine = (c.dist < c.includemargin)[0].numpy()
  if slots is not None:
    act, mine = act & slots, mine & slots
  if as_set:
    i = _by_bodies(c.bary_body[0].numpy(), np.nonzero(mine)[0])
    j = _by_bodies(np.asarray(cj.bary_body), np.nonzero(act)[0])
    assert len(i) == len(j)
    _compare(c, cj, i, j, tol)
    return len(i)
  np.testing.assert_array_equal(mine, act)
  i = np.nonzero(act)[0]
  _compare(c, cj, i, i, tol)
  return len(i)


def _compare(c, cj, i, j, tol):
  """Slots ``i`` of the port's lane 0 against slots ``j`` of the JAX
  package's."""
  for name in ("dist", "pos", "frame", "bary_w", "friction", "solref",
               "solimp", "includemargin"):
    np.testing.assert_allclose(getattr(c, name)[0].numpy()[i],
                               np.asarray(getattr(cj, name))[j], rtol=0,
                               atol=tol, err_msg=name)
  for name in ("geom1", "geom2"):
    np.testing.assert_array_equal(getattr(c, name)[0].numpy()[i],
                                  np.asarray(getattr(cj, name))[j],
                                  err_msg=name)
  # a body of weight 0 is padding, whatever its id
  w = np.asarray(cj.bary_w)[j]
  np.testing.assert_array_equal(
      np.where(w != 0, c.bary_body[0].numpy()[i], 0),
      np.where(w != 0, np.asarray(cj.bary_body)[j], 0), err_msg="bary_body")


def group_slots(m, kind: str, gtype: int = None) -> np.ndarray:
  """(ncon,) bool: the slots of the model's element groups of ``kind``
  (and partner type ``gtype``)."""
  from mujoco_inversedynamicstest_tpu_torch.ops import collision

  lay = collision.contact_layout(m)
  out = np.zeros(lay.ncon, bool)
  i = sum(g.npair_run * g.nslot for g in lay.groups)
  for eg in lay.elem_groups:
    n = eg.npair_run * eg.nslot
    if eg.kind == kind and (gtype is None or eg.gtype == gtype):
      out[i:i + n] = True
    i += n
  return out
