"""The port's viewer driver (headless) and offscreen renderer.

The four tests of the JAX package's ``tests/test_viewer.py`` on the port:
the watch pane, the profiler pane, the profiler on a lane of a fleet, an
unknown watch field refused.  The renderer against a recording stand-in
for ``mujoco.Renderer``: the lane it is asked for, one host copy of the
fleet a batch, and an ``MjData`` equal to C's forward of that lane.  A
real render where a GL context can be made.
"""

import torch_threads  # noqa: F401  (first: pins torch's threads)

import mujoco
import numpy as np
import pytest
import torch

import mujoco_inversedynamicstest_tpu_torch as mt
from mujoco_inversedynamicstest_tpu_torch import renderer as renderer_mod

from test_viewer import XML


def _model():
  return mt.load_model(XML, device="cpu"), mujoco.MjModel.from_xml_string(XML)


def test_headless_loop_with_watch(capsys):
  m, mjm = _model()
  out = mt.viewer.launch(m, mjm=mjm, max_steps=5, watch="qpos",
                         watch_every=0.0, _headless_smoke=True)
  assert torch.isfinite(out.qpos).all()
  assert "[watch]" in capsys.readouterr().out


def test_headless_loop_with_profiler_pane(capsys):
  m, mjm = _model()
  out = mt.viewer.launch(m, mjm=mjm, max_steps=5, profile=True,
                         profile_every=0.0, _headless_smoke=True)
  assert torch.isfinite(out.qpos).all()
  text = capsys.readouterr().out
  assert "[profile]" in text and "steps/s" in text and "newton iters" in text


def test_profiler_pane_batched_lane(capsys):
  m, mjm = _model()
  fleet = mt.make_data(m, 3)
  fleet = fleet.replace(qvel=torch.tensor([[0.0], [0.5], [0.0]],
                                          dtype=torch.float64))
  seen = []
  out = mt.viewer.launch(m, fleet, mjm=mjm, index=1, max_steps=4,
                         profile=True, profile_every=0.0, watch="qvel",
                         watch_every=0.0, _headless_smoke=True,
                         ctrl_fn=lambda d: seen.append(d.batch) or d)
  text = capsys.readouterr().out
  assert "[profile]" in text and seen == [3] * 4 and out.batch == 3
  # the watch pane prints the lane it renders: lane 1 moves
  assert "qvel = [0.]" not in text.split("[watch]")[1]


def test_unknown_watch_field_refused():
  m, mjm = _model()
  with pytest.raises(AttributeError, match="nope"):
    mt.viewer.launch(m, mjm=mjm, max_steps=1, watch="nope",
                     _headless_smoke=True)


class RecordingRenderer:
  """Stands in for ``mujoco.Renderer``: keeps a copy of each scene's MjData
  state and returns the lane's qpos as its 'pixels'."""

  def __init__(self, model, height, width, max_geom):
    self.model, self.scenes, self.modes = model, [], []

  def update_scene(self, mjd, camera=-1, scene_option=None):
    self.scenes.append({f: np.array(getattr(mjd, f)) for f in (
        "qpos", "qvel", "xpos", "xquat", "qacc", "geom_xpos")})

  def render(self):
    return np.array(self.scenes[-1]["qpos"])

  def enable_depth_rendering(self):
    self.modes.append("depth")

  def disable_depth_rendering(self):
    self.modes.append("rgb")

  def close(self):
    self.modes.append("closed")


def test_renderer_lane_copy_and_state(monkeypatch):
  m, mjm = _model()
  rng = np.random.RandomState(1)
  qpos, qvel = rng.randn(4, m.nq), rng.randn(4, m.nv)
  fleet = mt.from_jax_arrays(m, dict(qpos=qpos, qvel=qvel))
  monkeypatch.setattr(mujoco, "Renderer", RecordingRenderer)
  copies = []
  real_copy = renderer_mod.host_copy
  monkeypatch.setattr(renderer_mod, "host_copy",
                      lambda d: copies.append(d.batch) or real_copy(d))

  with mt.renderer.Renderer(m, mjm, height=8, width=8) as r:
    np.testing.assert_array_equal(r.render(fleet, index=2), qpos[2])
    r.render(fleet, index=1, depth=True)
    frames = r.render_batch(fleet)
    rec = r._renderer
  assert rec.modes == ["depth", "rgb", "closed"]
  assert copies == [4] and frames.shape == (4, m.nq)
  np.testing.assert_array_equal(frames, qpos)
  for scene, lane in zip(rec.scenes, [2, 1, 0, 1, 2, 3]):
    mjd = mujoco.MjData(mjm)
    mjd.qpos[:], mjd.qvel[:] = qpos[lane], qvel[lane]
    mujoco.mj_forward(mjm, mjd)
    for f, v in scene.items():
      np.testing.assert_array_equal(v, getattr(mjd, f), err_msg=f)


def test_real_render_where_gl_exists():
  m, mjm = _model()
  try:
    r = mt.renderer.Renderer(m, mjm, height=32, width=32)
  except Exception as e:  # no EGL/OSMesa/GLFW context on this host
    pytest.skip(f"no GL context can be made here: {e}")
  with r:
    rgb = r.render(mt.make_data(m, 2), index=1)
  assert rgb.shape == (32, 32, 3) and rgb.dtype == np.uint8
