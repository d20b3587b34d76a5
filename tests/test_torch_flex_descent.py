"""Flex element contacts found by support descent in the PyTorch port (a
mesh, a cylinder and an ellipsoid against cloth; a mesh against a tet
cube and a cable), in float64 on the CPU: each group's narrowphase against the JAX package's, pair by pair, after
  the protocol of ``test_torch_collision_sdf.compare_descent_with_jax``:
  within 1e-9 of its jitted or its op-by-op run, which may part in the
  last bits; only at a knife edge (where those runs and both packages'
  runs a 1e-9 nudge away part by more than 1e-6: the descent's path turns
  on the last bits of its seeds) within 1e-8 of one of the reference's
  answers, or its depth within the descent's accuracy;
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import jax
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu as mi
import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu.ops import flexcol as jflexcol
from mujoco_inversedynamicstest_tpu_torch.models.types import GeomType
from mujoco_inversedynamicstest_tpu_torch.ops import collision, flexcol

import flex_cases as fc
from flex_cases import flex_models
from test_torch_collision_sdf import DESCENT_ACCURACY

_CABLE_MESH = """
<mujoco>
  <option timestep="0.001"/>
  {asset}
  <worldbody>
    <flexcomp type="grid" count="12 1 1" spacing="0.03 0.03 0.03"
              radius="0.01" name="cable" dim="1" mass="0.1">
      <contact selfcollide="none" internal="false"/>
      <edge equality="true"/>
      <pin id="0 11"/>
    </flexcomp>
    <body pos="0.0 0.0 0.04" euler="0 0 20"><freejoint/>
      <geom type="mesh" mesh="octa" mass="0.04"/></body>
  </worldbody>
</mujoco>
""".format(asset=flex_models.MESH_ASSET)

# (label, scene, C steps before the state, partner type)
CASES = {
    "sheet-mesh": ("flex_sheet_mesh", 300, GeomType.MESH),
    "sheet-cylinder": ("flex_sheet_cylinder", 300, GeomType.CYLINDER),
    "sheet-ellipsoid": ("flex_sheet_ellipsoid", 300, GeomType.ELLIPSOID),
    "tet-mesh": (flex_models.tet_xml(flex_models.EXTRAS[(
        "test_flex_elem.py", "test_box_on_tet_cube_settles_finite")].replace(
            'type="box" size="0.02 0.015 0.01"', 'type="mesh" mesh="octa"'))
                 .replace("<worldbody>", flex_models.MESH_ASSET
                          + "<worldbody>"), 250, GeomType.MESH),
    "cable-mesh": (_CABLE_MESH, 150, GeomType.MESH),
}


def _state(label):
  src, steps, gtype = CASES[label]
  mjm = fc.scene(src) if src.startswith("flex_") else fc.model(src)
  return mjm, fc.dropped(mjm, steps), gtype


def _group(m, gtype):
  lay = collision.contact_layout(m)
  k = next(i for i, g in enumerate(lay.elem_groups)
           if g.kind == "geom_elem" and g.gtype == gtype)
  return k, lay.elem_groups[k]


def _nudged(x, seed):
  return x + 1e-9 * np.random.RandomState(seed).randn(*x.shape)


def _outputs(dist, pos, nrm):
  return np.concatenate([np.asarray(dist)[:, None], np.asarray(pos),
                         np.asarray(nrm)], axis=1)


@pytest.mark.parametrize("label", sorted(CASES))
def test_descent_groups_match_jax(label):
  mjm, mjd, gtype = _state(label)
  m = mt.put_model(mjm, device="cpu")
  d = mt.fwd_position(m, mt.put_data(m, mjd))
  k, grp = _group(m, gtype)
  mj = mi.put_model(mjm, dtype=jax.numpy.float64)
  jgrp = jflexcol.build_elem_groups(mj)[k]
  # the JAX narrowphase reads the frames and vertex positions, which the
  # two packages compute alike (tests/test_torch_flex.py)
  dj = mi.make_data(mj).replace(
      geom_xmat=jax.numpy.asarray(d.geom_xmat[0].numpy()),
      geom_xpos=jax.numpy.asarray(d.geom_xpos[0].numpy()),
      flexvert_xpos=jax.numpy.asarray(d.flexvert_xpos[0].numpy()))
  assert (jgrp.kind, jgrp.gtype) == (grp.kind, grp.gtype)

  fn = lambda x: jflexcol.run_elem_group(mj, x, jgrp)[:3]
  jitted = jax.jit(fn)

  def jax_run(xpos, gpos, jit):
    dd = dj.replace(flexvert_xpos=jax.numpy.asarray(xpos),
                    geom_xpos=jax.numpy.asarray(gpos))
    if jit:
      return _outputs(*jitted(dd))
    with jax.disable_jit():
      return _outputs(*fn(dd))

  def port_run(xpos, gpos):
    dd = d.replace(flexvert_xpos=torch.as_tensor(xpos)[None],
                   geom_xpos=torch.as_tensor(gpos)[None])
    out = flexcol.run_elem_group(m, dd, grp)
    return _outputs(out.dist[0], out.pos[0], out.nrm[0])

  xpos, gpos = np.array(dj.flexvert_xpos), np.array(dj.geom_xpos)
  moved = [(_nudged(xpos, s), _nudged(gpos, s + 9)) for s in (1, 2)]
  ref = [jax_run(xpos, gpos, True), jax_run(xpos, gpos, False)]
  ref += [jax_run(x, g, True) for x, g in moved]
  got = port_run(xpos, gpos)
  near = [port_run(x, g) for x, g in moved]
  exact = ties = 0
  bad = []
  for i in range(len(got)):
    # the jitted or the op-by-op run (they may part in the last bits)
    if min(np.abs(r[i] - got[i]).max() for r in ref[:2]) <= 1e-9:
      exact += 1
      continue
    spread = max(np.abs(ref[0][i] - r[i]).max() for r in ref[1:] + near)
    if spread <= 1e-6:
      bad.append((i, "stable", np.abs(ref[0][i] - got[i]).max()))
      continue
    ties += 1
    if min(np.abs(r[i] - got[i]).max() for r in ref) <= 1e-8:
      continue
    gap = min(abs(min(r[i, 0], 0.0) - min(got[i, 0], 0.0)) for r in ref)
    if gap > DESCENT_ACCURACY:
      bad.append((i, "tie", gap))
  print(f"{label}: {exact} pairs within 1e-9, {ties} at a knife edge")
  assert not bad, bad[:8]
  assert (ref[0][:, 0] < 0).sum() >= 1
