"""Interactive viewer driver: the port steps, the host renders.

Port of the JAX package's ``viewer.py``, the analog of the
reference's ``python/mujoco/viewer.py`` (``launch_passive`` :540): the
port's ``step`` runs on the model's device in a loop and each state is
mirrored into a passive ``mujoco.viewer`` handle through
``models/interop.get_data``.  The port's ``Model`` keeps no ``MjModel``:
pass the one it was built from as ``mjm``.

Usage::

    m = mt.load_model(xml)
    mjm = mujoco.MjModel.from_xml_string(xml)
    mt.viewer.launch(m, mjm=mjm)                  # until the window closes
    mt.viewer.launch(m, fleet, mjm=mjm, index=3)  # watch lane 3 of a fleet
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from mujoco_inversedynamicstest_tpu_torch.models import interop
from mujoco_inversedynamicstest_tpu_torch.models.types import Data, Model


def launch(
    m: Model,
    d: Optional[Data] = None,
    *,
    mjm=None,
    index: Optional[int] = None,
    ctrl_fn: Optional[Callable[[Data], Data]] = None,
    realtime: bool = True,
    max_steps: Optional[int] = None,
    watch: Optional[str] = None,
    watch_every: float = 0.5,
    profile: bool = False,
    profile_every: float = 2.0,
    _headless_smoke: bool = False,
) -> Data:
  """Steps the port and mirrors lane ``index`` into the host viewer.

  Args:
    m: the port's Model.
    d: the initial fleet (``make_data(m, 1)`` by default); ``index``
      selects the rendered lane (default 0).
    mjm: the ``mujoco.MjModel`` ``m`` was built from (the window and the
      mirror need it; a headless run without it mirrors nothing).
    ctrl_fn: a callback ``Data -> Data`` run before each step (set ctrl,
      apply forces).
    realtime: sleep to track the model timestep; False runs as fast as
      the device allows.
    max_steps: stop after this many steps (None: until the window closes).
    watch: a Data field printed every ``watch_every`` seconds, the
      simulate app's Watch pane in the terminal.
    profile: print every ``profile_every`` seconds the realized steps/s,
      realtime factor, ms a step, Newton iterations, active contacts and
      constraint rows, and warnings: the simulate app's Profiler pane.
    _headless_smoke: run the loop without a window (10 steps unless
      ``max_steps``).

  Returns the final Data.
  """
  from mujoco_inversedynamicstest_tpu_torch.models import io as io_mod
  from mujoco_inversedynamicstest_tpu_torch.ops import forward as forward_mod

  if d is None:
    d = io_mod.make_data(m, 1)
  index = 0 if index is None else index
  if watch is not None and not hasattr(d, watch):
    raise AttributeError(f"watch: Data has no field '{watch}'")

  def step(dd):
    return forward_mod.step(m, dd)

  mjd = None
  if mjm is not None:
    import mujoco

    mjd = mujoco.MjData(mjm)

  def sync_into(handle_mjd, d):
    if handle_mjd is not None:
      interop.get_data(m, d, mjm, mjd=handle_mjd, index=index)

  def read_perturb(d, handle_mjd):
    """Mouse perturbations back into the port's state (the simulate app's
    read-back: ``mjv_applyPerturbForce`` writes ``xfrc_applied``, a pose
    perturbation writes the mocap bodies).  The rendered lane takes them;
    the other lanes are untouched."""
    lane = lambda name: torch.as_tensor(
        np.asarray(getattr(handle_mjd, name)), device=d.qpos.device,
        dtype=d.qpos.dtype)
    updates = {}
    xf = np.asarray(handle_mjd.xfrc_applied)
    if xf.any() or bool((d.xfrc_applied[index] != 0).any()):
      updates["xfrc_applied"] = d.xfrc_applied.clone()
      updates["xfrc_applied"][index] = lane("xfrc_applied")
    if m.nmocap:
      for name in ("mocap_pos", "mocap_quat"):
        updates[name] = getattr(d, name).clone()
        updates[name][index] = lane(name)
    return d.replace(**updates) if updates else d

  nstep = 0
  dt = float(m.opt.timestep)
  last_watch = [0.0]

  def maybe_watch(d):
    if watch is None:
      return
    now = time.perf_counter()
    if now - last_watch[0] < watch_every:
      return
    last_watch[0] = now
    val = getattr(d, watch)
    one = val[index] if isinstance(val, torch.Tensor) and val.ndim else val
    if isinstance(one, torch.Tensor):
      one = one.detach().cpu().numpy()
    with np.printoptions(precision=4, suppress=True, threshold=12):
      print(f"[watch] t={nstep * dt:8.3f} {watch} = {np.asarray(one)}")

  # the Profiler pane: counters over the wall-clock interval
  prof = {"t0": time.perf_counter(), "n0": 0}

  def maybe_profile(d):
    if not profile:
      return
    now = time.perf_counter()
    wall = now - prof["t0"]
    if wall < profile_every:
      return
    steps = nstep - prof["n0"]
    prof["t0"], prof["n0"] = now, nstep
    lane = lambda x: x[index].detach().cpu().numpy()
    niter = int(lane(d.solver_niter)) if d.solver_niter is not None else 0
    nefc_act = (int(lane(d.efc_active).sum()) if d.efc_active is not None
                else 0)
    con = d.contact
    ncon_act = (int((lane(con.dist) < lane(con.includemargin)).sum())
                if con is not None and con.dist is not None else 0)
    warn = lane(d.warning) if d.warning is not None else None
    rate = steps / max(wall, 1e-9)
    print(
        f"[profile] {rate:9.1f} steps/s ({rate * dt:5.2f}x realtime, "
        f"{1e3 / max(rate, 1e-9):6.2f} ms/step) | newton iters {niter:3d} "
        f"| contacts {ncon_act:3d} efc {nefc_act:4d}"
        + (f" | warnings {warn.tolist()}" if warn is not None
           and warn.any() else ""))

  if _headless_smoke:
    while max_steps is None or nstep < max_steps:
      if ctrl_fn is not None:
        d = ctrl_fn(d)
      d = step(d)
      sync_into(mjd, d)
      maybe_watch(d)
      maybe_profile(d)
      nstep += 1
      if max_steps is None and nstep >= 10:
        break
    return d

  if mjm is None:
    raise ValueError("launch needs the MjModel (mjm=) to open a window")
  import mujoco.viewer

  # render at display rate, stepping as many times a frame as the wall
  # clock asks (the reference viewer's pattern)
  frame_dt = 1.0 / 60.0
  with mujoco.viewer.launch_passive(mjm, mjd) as handle:
    sim_ahead = 0.0  # simulated seconds minus wall seconds
    t_prev = time.perf_counter()
    while handle.is_running() and (max_steps is None or nstep < max_steps):
      now = time.perf_counter()
      if realtime:
        sim_ahead -= now - t_prev
        t_prev = now
        # never fall more than one frame behind
        sim_ahead = max(sim_ahead, -frame_dt)
        n_sub = max(1, int(-sim_ahead / dt) + 1) if sim_ahead < 0 else 0
      else:
        n_sub = max(1, int(frame_dt / dt))
      for _ in range(n_sub):
        if max_steps is not None and nstep >= max_steps:
          break
        if ctrl_fn is not None:
          d = ctrl_fn(d)
        d = step(d)
        nstep += 1
        sim_ahead += dt
      sync_into(mjd, d)
      handle.sync()
      maybe_watch(d)
      maybe_profile(d)
      d = read_perturb(d, mjd)
      if realtime:
        leftover = frame_dt - (time.perf_counter() - now)
        if leftover > 0:
          time.sleep(leftover)
  return d
